"""The benchmark's description, read from ``BENCHMARK.json`` at the root of a
checkout: a cell (one entry of ``workloads``) resolved to its configuration
file, its traffic file, its driver and the reader of each metric it reports.

Nothing here names a cell, a configuration or a metric: every name comes
from ``BENCHMARK.json``, and each is found as a file of the same name
(``configs/<config>.json`` by the configuration's ``file``,
``traffic/<traffic>.json``, ``drivers/<driver>.py``, ``metrics/<metric>.py``,
or ``metrics/<base>.py`` for a split metric ``<base>.<part>`` with no file of its own).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")

    def metrics(kind):
        return tuple(Metric(m["name"], m["unit"]) for m in bench[kind] if _applies(m, name))

    return Cell(name, int(w["chips"]), config, traffic, metrics("end_to_end"),
                metrics("per_layer"))


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def driver_module(kind: str) -> ModuleType:
    """``drivers/<kind>.py``: ``setup``, ``window``, ``segment``, ``check`` and ``control``."""
    return _load_module(BENCH_DIR / "drivers" / f"{kind}.py", f"mcmcbench_driver_{kind}")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``: ``read(run) -> float | None``. A split metric
    (``<base>.<part>``) with no file of its own reads ``metrics/<base>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{name.split('.', 1)[0]}.py"
    return _load_module(path, "mcmcbench_metric_" + name.replace(".", "_"))
