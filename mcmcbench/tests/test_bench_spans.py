"""The readers of the step spans' metrics on a hand-built segment (spans in
the program's ring, device operations in the trace), each against its value
worked out by hand; None with no spans, with spans but no stream times (the
CPU), and on a program without step spans. A tiny traced CPU run finds its
segment's one step tree. The new ``per_layer`` entries have their readers
and name only accepted cells."""
import json
import time
import types

import pytest
import torch

from mcmcbench.lib import harness, spec
from mcmcbench.lib import spans as lib_spans
from mcmcbench.lib.trace import Trace
from mcmcbench.tests import tiny
from repro_torch.obs import trace

BENCH = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ("propose_ms.lm", "prior_ms.lm", "forward_ms_per_round.lm", "round_self_ms.lm")


def _span(tid, sid, parent, name, start, dur, dev=None, **tags):
    s = {"trace_id": tid, "span_id": sid, "parent_id": parent, "name": name, "stage": "x",
         "start_s": start, "dur_s": dur, "pid": 1, "clock": "profiler", **tags}
    if dev is not None:
        s["dev_start_s"], s["dev_dur_s"] = 0.0, dev
    return s


def _step(tid, t0, propose, prior, rounds, dev=True):
    """An ``lm.step`` tree at host time ``t0``; ``rounds``: per round
    (round's stream s, [(forward's host start, host end, stream s)])."""
    d = (lambda x: x) if dev else (lambda x: None)
    out = [_span(tid, tid, None, "lm.step", t0, 1.0, d(0.9)),
           _span(tid, tid + "p", tid, "lm.propose", t0, 0.1, d(propose)),
           _span(tid, tid + "q", tid, "lm.prior", t0 + 0.1, 0.1, d(prior))]
    for i, (own, fwd) in enumerate(rounds):
        rid = f"{tid}r{i}"
        out.append(_span(tid, rid, tid, "test.round", fwd[0][0], fwd[-1][1] - fwd[0][0], d(own),
                         round=i))
        out += [_span(tid, f"{rid}f{j}", rid, "lm.forward", a, b - a, d(s))
                for j, (a, b, s) in enumerate(fwd)]
    return out


def _segment(dev=True):
    """Two steps in the segment and one before it (its root far from every
    device operation, so it is not read)."""
    return (_step("a", 100.0, 0.2, 0.1, [(0.25, [(100.5, 100.6, 0.11), (100.6, 100.8, 0.12)]),
                                         (0.30, [(100.8, 100.85, 0.14), (100.85, 100.9, 0.13)])],
                  dev)
            + _step("b", 101.0, 0.4, 0.3, [(0.20, [(101.5, 101.6, 0.09), (101.6, 101.7, 0.10)])],
                    dev)
            + _step("old", 50.0, 9.0, 9.0, [(9.0, [(50.5, 50.6, 9.0), (50.6, 50.7, 9.0)])], dev))


# device operations (name, start, duration): the segment's two steps
OPS = [("k", 100.45, 0.1), ("k", 100.7, 0.05), ("k", 100.82, 0.03), ("k", 101.55, 0.02),
       ("k", 101.56, 0.01), ("k", 101.9, 0.2)]
EXPECTED = {
    "propose_ms.lm": 1e3 * (0.2 + 0.4) / 2,
    "prior_ms.lm": 1e3 * (0.1 + 0.3) / 2,
    "forward_ms_per_round.lm": 1e3 * (0.23 + 0.27 + 0.19) / 3,
    "round_self_ms.lm": 1e3 * (0.02 + 0.03 + 0.01) / 3,
}


def _run(spans, ops=OPS, monkeypatch=None):
    ring = trace.Tracer()
    for s in spans:
        ring.emit(s)
    monkeypatch.setattr(trace, "default_tracer", lambda: ring)
    tr = Trace(2.0, 0.0, ops, [], []) if ops is not None else None
    return types.SimpleNamespace(trace=tr, segment={}, stats={})


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_on_a_hand_built_segment(name, monkeypatch):
    reader = spec.metric_reader(name)
    assert reader.read(_run(_segment(), monkeypatch=monkeypatch)) == pytest.approx(
        EXPECTED[name], rel=1e-9)
    assert reader.read(_run([], monkeypatch=monkeypatch)) is None
    # no stream times: the CPU
    assert reader.read(_run(_segment(dev=False), monkeypatch=monkeypatch)) is None
    monkeypatch.delattr(trace, "default_tracer")  # a program without step spans
    assert reader.read(types.SimpleNamespace(trace=Trace(2.0, 0.0, OPS, [], []))) is None


def test_step_trees_read_the_segment_only(monkeypatch):
    trees = lib_spans.step_trees(_run(_segment(), monkeypatch=monkeypatch))
    assert [t[0]["trace_id"] for t in trees] == ["a", "b"]
    assert [len(t) for t in trees] == [3 + 2 * 3, 3 + 3]
    everything = lib_spans.step_trees(_run(_segment(), ops=None, monkeypatch=monkeypatch))
    assert len(everything) == 3


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_entry(name):
    entry, = (m for m in BENCH["per_layer"] if m["name"] == name)
    assert (spec.BENCH_DIR / "metrics" / f"{name}.py").exists()
    assert entry["workloads"] == [tiny.LM_CELL]
    assert set(entry["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    assert entry["moves"] == "lm_steps_per_s" and entry["better"] == "lower"
    assert entry["source"] == "program_counter"


def test_tiny_traced_run_finds_its_step_tree():
    """The tiny LM cell traced on the CPU: the segment's one step is in the
    ring as one tree; its stream times and device operations are absent, so
    the four metrics are left out of the line."""
    trace.install(None)
    try:
        out = harness.run_cell(tiny.lm_cell(), 2 ** 31 + 5, 0.2, True, torch.device("cpu"),
                               time.monotonic())
        spans = trace.default_tracer().spans()
    finally:
        trace.install(None)
    roots = [s for s in spans if s["name"] == "lm.step"]
    assert len(roots) == tiny.lm_cell().traffic["trace_steps"]
    names = [s["name"] for s in spans]
    assert names.count("test.round") >= 1 and names.count("lm.forward") >= 2
    assert not set(SPAN_METRICS) & set(out["metrics"])
