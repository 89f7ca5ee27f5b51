"""Step spans (``repro_torch.obs.trace.span``) inside the LM step, on the
CPU at ``reduce_config`` sizes: off and free without a profiler or an
installed tracer; under ``torch.profiler`` one tree a step with the
proposal, the prior, the test's rounds and the forwards, on the profiler's
clock; the step's outputs the same bits either way; the stream-time
resolution of ``Tracer.flush`` on stand-in events; ``launch.train
--trace-dir``. Torch only."""
import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.bayes import (LogLikCache, TrainConfig, make_cached_train_step, make_exact_step,
                               make_train_step)
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.core import make_sampler, sequential_test
from repro_torch.data import DataConfig, TokenStream
from repro_torch.models import init_params
from repro_torch.models.transformer import _flatten
from repro_torch.obs import trace

POOL = 8
KINDS = ("plain", "exact", "cached")


@pytest.fixture(autouse=True)
def fresh_ring():
    """Each test starts from the process's own empty ring, spans off."""
    trace.install(None)
    yield
    trace.install(None)


@pytest.fixture(scope="module")
def lm():
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    params = init_params(0, cfg, device="cpu")
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=12, global_batch=POOL, seed=0),
                        device="cpu").batch(0)
    return cfg, params, batch


def _step(kind, lm, seed=5):
    """One step of ``kind`` from generator seed ``seed``: (params', info).
    The cached step starts from a cache valid everywhere, so each round runs
    the theta' forward alone."""
    cfg, params, batch = lm
    tc = TrainConfig(round_batch=2, epsilon=0.01, sigma=1e-3)
    gen = torch.Generator().manual_seed(seed)
    if kind == "cached":
        cache = LogLikCache(torch.zeros(POOL), torch.ones(POOL, dtype=torch.bool),
                            np.ones(POOL, dtype=bool))
        new, _, info = make_cached_train_step(cfg, tc)(gen, params, batch, cache)
        return new, info
    maker = make_train_step if kind == "plain" else make_exact_step
    return maker(cfg, tc)(gen, params, batch)


def _profiled(fn):
    """``fn()`` under the profiler on the CPU: (its result, the profiler's
    (name, start s, end s, a user annotation) events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9,
               e.is_user_annotation()) for e in prof.profiler.kineto_results.events()]
    return out, events


@pytest.mark.parametrize("kind", KINDS)
def test_spans_off_record_nothing_and_enter_no_range(kind, lm, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    _step(kind, lm)
    assert trace.default_tracer().spans() == []
    assert trace.span("lm.step", "step") is trace.span("lm.prior", "prior")


@pytest.mark.parametrize("kind", KINDS)
def test_step_spans_under_the_profiler(kind, lm):
    """One ``lm.step`` tree: one ``lm.propose`` and one ``lm.prior`` under
    the root, ``info.rounds`` x ``test.round`` each holding its forwards
    (two; one where the cached slice is all valid; the exact step's
    forwards sit under the root), every span of one ``trace_id``, each
    matched by a profiler event of its name within 5 ms at both ends; no
    such event is a user annotation (which the profiler would mirror on a
    card's timeline as a device event over the span's kernels)."""
    (_, info), events = _profiled(lambda: _step(kind, lm))
    spans = trace.default_tracer().spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    root, = by_name["lm.step"]
    rounds = int(info.rounds)
    assert root["parent_id"] is None and root["stage"] == "step"
    assert {s["stage"] for s in spans} <= {"step", "propose", "prior", "round", "forward"}
    assert {s["trace_id"] for s in spans} == {root["trace_id"]}
    assert len({s["span_id"] for s in spans}) == len(spans)
    for name in ("lm.propose", "lm.prior"):
        one, = by_name[name]
        assert one["parent_id"] == root["span_id"]
    assert by_name["lm.propose"][0]["proposal"] == "rw"
    fwd = by_name["lm.forward"]
    if kind == "exact":
        assert "test.round" not in by_name
        assert len(fwd) == 2 * rounds and rounds == POOL // 2
        assert all(f["parent_id"] == root["span_id"] for f in fwd)
    else:
        tests = by_name["test.round"]
        assert [t["round"] for t in tests] == list(range(rounds))
        per_round = 1 if kind == "cached" else 2
        assert len(fwd) == per_round * rounds
        for t in tests:
            assert t["parent_id"] == root["span_id"]
            kids = [f["params"] for f in fwd if f["parent_id"] == t["span_id"]]
            assert kids == ["theta_p", "theta"][:per_round]
    for s in spans:
        assert s["clock"] == "profiler" and s["dur_s"] >= 0
        assert s["start_s"] + s["dur_s"] <= root["start_s"] + root["dur_s"] + 1e-6
    for name, mine in by_name.items():
        theirs = sorted((e for e in events if e[0] == name), key=lambda e: e[1])
        assert len(theirs) == len(mine), name
        for s, (_, start, end, annotation) in zip(sorted(mine, key=lambda s: s["start_s"]),
                                                  theirs):
            assert not annotation, name
            assert abs(s["start_s"] - start) < 5e-3, name
            assert abs(s["start_s"] + s["dur_s"] - end) < 5e-3, name


@pytest.mark.parametrize("kind", KINDS)
def test_step_outputs_equal_with_spans_on_and_off(kind, lm):
    new_off, info_off = _step(kind, lm, seed=9)
    (new_on, info_on), _ = _profiled(lambda: _step(kind, lm, seed=9))
    assert trace.default_tracer().spans()
    for f in info_off._fields:
        a, b = getattr(info_off, f), getattr(info_on, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for a, b in zip(_flatten(new_off).values(), _flatten(new_on).values()):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("switch", ("profiler", "installed"))
def test_a_bare_test_records_no_span(switch):
    """The test alone, as a BayesLR ensemble or the serve path runs it,
    records nothing under the profiler or with an installed tracer; inside
    an open ``lm.step`` its rounds are that step's children."""
    tracer = trace.Tracer()
    if switch == "installed":
        trace.install(tracer)
    state0, reset, draw = make_sampler("stream", 1000, device="cpu")

    def test():
        return sequential_test(None, mu0=torch.tensor(0.0), draw_fn=draw,
                               eval_fn=lambda idx: torch.sin(idx.float()),
                               sampler_state=reset(state0), num_sections=1000, batch_size=50,
                               epsilon=0.05)

    run = test if switch == "installed" else lambda: _profiled(test)[0]
    res = run()
    assert int(res.rounds) > 1 and trace.default_tracer().spans() == []
    with (contextlib.nullcontext() if switch == "installed"
          else profile(activities=[ProfilerActivity.CPU])):
        with trace.span("lm.step", "step", root=True) as root:
            res = test()
    spans = trace.default_tracer().spans()
    assert [s["name"] for s in spans] == ["test.round"] * int(res.rounds) + ["lm.step"]
    assert all(s["parent_id"] == root["span_id"] for s in spans[:-1])


class _Event:
    """A stand-in for a ``torch.cuda.Event`` recorded at ``t_ms`` on the stream."""

    def __init__(self, t_ms):
        self.t_ms, self.waited = t_ms, False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


def test_flush_resolves_stream_times_and_holds_the_tee_back(tmp_path):
    path = tmp_path / "spans.jsonl"
    tracer = trace.Tracer(jsonl_path=str(path))
    root_open, root_close = _Event(100.0), _Event(160.0)
    kid_open, kid_close = _Event(110.0), _Event(135.0)
    kid = trace.span_close(trace.span_open("t", "lm.forward", "forward", "r", clock="profiler"))
    root = trace.span_close(trace.span_open("t", "lm.step", "step", clock="profiler"))
    tracer.emit(kid, (kid_open, kid_close, root_open))
    tracer.emit(root, (root_open, root_close, root_open))
    served = trace.span_close(trace.span_open("u", "request:w", "request"))
    tracer.emit(served)
    assert "clock" not in served
    assert [json.loads(line)["name"] for line in path.read_text().splitlines()] == ["request:w"]
    assert "dev_dur_s" not in kid
    spans = tracer.spans()
    assert kid_close.waited and root_close.waited
    assert kid["dev_start_s"] == pytest.approx(0.010) and kid["dev_dur_s"] == pytest.approx(0.025)
    assert root["dev_start_s"] == 0.0 and root["dev_dur_s"] == pytest.approx(0.060)
    assert [s["name"] for s in spans] == ["lm.forward", "lm.step", "request:w"]
    tracer.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [s["name"] for s in lines] == ["request:w", "lm.forward", "lm.step"]
    assert lines[1]["dev_dur_s"] == pytest.approx(0.025)


def test_train_launcher_trace_dir_writes_a_tree_a_step(tmp_path, capsys):
    from repro_torch.launch import train

    trace_dir = tmp_path / "trace"
    out = train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "8",
                      "--seq", "12", "--ckpt-dir", str(tmp_path / "ck"),
                      "--trace-dir", str(trace_dir)])
    assert trace.default_tracer() is not None and trace.span("x", "step") is trace._OFF
    spans = trace.load_spans(str(trace_dir))
    roots = [s for s in spans if s["name"] == "lm.step"]
    assert len(roots) == len(out["infos"]) == 2
    for root, info in zip(roots, out["infos"]):
        tree = [s for s in spans if s["trace_id"] == root["trace_id"]]
        names = [s["name"] for s in tree]
        assert names.count("lm.propose") == names.count("lm.prior") == 1
        assert names.count("test.round") == info["rounds"]
        assert names.count("lm.forward") == 2 * info["rounds"]
    assert trace.main(["--export", str(trace_dir)]) == 0
    chrome = json.loads((trace_dir / "trace.json").read_text())
    assert len(chrome["traceEvents"]) == len(spans)
    assert {e["name"] for e in chrome["traceEvents"]} == {
        "lm.step", "lm.propose", "lm.prior", "test.round", "lm.forward"}
    assert os.path.basename(str(trace_dir)) in capsys.readouterr().out
