"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
the contract's shape."""
import json
import re

import pytest

from mcmcbench.lib import spec
from mcmcbench.tests.tiny import ROOT, held_out_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
HELD_OUT = sorted(p.stem for p in (spec.BENCH_DIR / "held_out").glob("*.json"))


@pytest.mark.parametrize("cell", CELLS + HELD_OUT)
def test_cell_resolves(cell):
    c = spec.load_cell(ROOT, cell) if cell in CELLS else held_out_cell(cell)
    driver = spec.driver_module(c.driver)
    for fn in ("setup", "window", "segment", "check", "control"):
        assert callable(getattr(driver, fn)), fn
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m.name).read), m.name
    assert {"setup_s"} < {m.name for m in c.end_to_end}
    assert c.per_layer
    limits = json.loads((spec.BENCH_DIR / "limits" / f"{cell}.json").read_text())["limits"]
    assert limits and all(v["limit"] >= 0 for v in limits.values())


def test_configs_and_names():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert c["file"].startswith("mcmcbench/")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024
