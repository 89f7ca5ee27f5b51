"""One run of one cell: set-up, the measured window, an optional traced
segment, the check against the plain reference, and the result line.

The cell's driver (``drivers/<traffic's driver>.py``) provides

- ``setup(cell, seed, device) -> state``: inputs drawn from the seed, the
  program built and warmed at the cell's shapes, burn-in, and what the check
  will read;
- ``window(state, seconds) -> stats``: the timed loop, at least ``seconds``
  long, ending at a synchronize; ``stats`` holds ``window_s``, ``attempted``,
  ``failed`` and the counters the readers take;
- ``segment(state) -> stats``: a short stretch of the same loop, run under
  the profiler in a ``--trace 1`` run;
- ``check(state) -> {name: value}``: after the program's state is freed, the
  numbers compared with the reference, each held to its limit in
  ``limits/<cell>.json``.

Each metric's value comes from ``metrics/<name>.py`` (``read(run)``); a
reader that finds nothing to read returns None and the metric is left out.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

import torch

from . import env, spec
from . import trace as tracing


@dataclasses.dataclass
class Run:
    cell: spec.Cell
    device: torch.device
    kind: str  # the card's name
    setup_s: float
    stats: dict  # the window's counters
    trace: tracing.Trace | None = None
    segment: dict | None = None  # the traced segment's counters


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def load_limits(cell: str) -> dict:
    path = spec.BENCH_DIR / "limits" / f"{cell}.json"
    return spec.load_json(path)["limits"]


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, *, limits: dict | None = None) -> dict:
    """Run ``cell`` once and return the result line's object (without
    printing). Raises RuntimeError if a forbidden module is loaded."""
    driver = spec.driver_module(cell.driver)
    limits = load_limits(cell.name) if limits is None else limits
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    state = driver.setup(cell, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.monotonic() - t_start
    stats = driver.window(state, seconds)
    run = Run(cell, device, device_kind(device), setup_s, stats)
    if trace:
        run.segment, run.trace = tracing.capture(lambda: driver.segment(state), device)
    _refuse_forbidden()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    values = driver.check(state)
    del state
    checks = {name: {"value": float(values[name]), "limit": float(lim["limit"])}
              for name, lim in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m.name).read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    out = {"correct": bool(correct), "attempted": int(stats["attempted"]),
           "failed": int(stats["failed"]), "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                      "kind": run.kind, "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops, "idle_gaps": run.trace.idle_gaps}
    _refuse_forbidden()
    out["checks"] = checks
    return out


def _refuse_forbidden() -> None:
    found = env.forbidden_loaded()
    if found:
        raise RuntimeError(f"forbidden modules are loaded: {', '.join(found)}")


def emit(out: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in out["checks"].items():
        mark = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {mark}", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)

