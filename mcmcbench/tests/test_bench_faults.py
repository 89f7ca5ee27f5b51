"""The check fails a run whose timed path is broken underneath, and passes
a sound one; the control (the reference in a lower precision) reads well
above the program. Run on the CPU at tiny sizes, the look for a card
skipped."""
import copy
import dataclasses
import time

import pytest
import torch

from mcmcbench.lib import harness, spec
from mcmcbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def _run(cell, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, False, CPU, time.monotonic())


def _with_sigma(cell, sigma):
    """The tiny LM cell with a random-walk step at which its bf16 weights
    move (at the cell's own 1e-4 almost none of them do)."""
    cfg = copy.deepcopy(cell.config)
    cfg["posterior"]["sigma"] = sigma
    return dataclasses.replace(cell, config=cfg)


@pytest.mark.parametrize("which", ["lm", "lr"])
def test_sound_run_is_correct(which):
    out = _run(tiny.lm_cell() if which == "lm" else tiny.lr_cell())
    assert out["correct"], out["checks"]


def _state_unchanged_lm(mp):
    from repro_torch.bayes import train as bt

    make = bt.make_train_step

    def broken(*a, **k):
        step = make(*a, **k)
        return lambda gen, params, batch: (params, step(gen, params, batch)[1])

    mp.setattr(bt, "make_train_step", broken)


def _half_batch(mp):
    from repro_torch.kernels import ops

    orig = ops.t_test_round

    def broken(l, valid, *a, **k):
        valid = valid.clone()
        valid[..., valid.shape[-1] // 2:] = False
        return orig(l, valid, *a, **k)

    mp.setattr(ops, "t_test_round", broken)


def _answer_altered_lm(mp):
    from repro_torch.bayes import train as bt

    orig = bt.forward_loglik
    calls = []

    def broken(params, batch, *a, **k):  # the first row of every other forward, 5 nats up
        out = orig(params, batch, *a, **k)
        calls.append(None)
        return out + (torch.arange(out.shape[0]) == 0).to(out.dtype) * 5.0 * (len(calls) % 2)

    mp.setattr(bt, "forward_loglik", broken)


def _proposal_altered_lm(mp):
    from repro_torch.bayes import train as bt

    orig = bt._perturb_leaf
    mp.setattr(bt, "_perturb_leaf", lambda gen, leaf, sigma: orig(gen, leaf, 3.0 * sigma))


def _state_unchanged_lr(mp):
    from repro_torch.core import ensemble

    mp.setattr(ensemble, "tree_select", lambda cond, a, b: b)


def _answer_altered_lr(mp):
    from repro_torch.kernels import ops

    orig = ops.gather_and_delta
    mp.setattr(ops, "gather_and_delta", lambda *a, **k: orig(*a, **k) + 0.01)


@pytest.mark.parametrize("which,fault", [
    ("lm", _state_unchanged_lm), ("lm", _half_batch), ("lm", _answer_altered_lm),
    ("lm", _proposal_altered_lm),
    ("lr", _state_unchanged_lr), ("lr", _half_batch), ("lr", _answer_altered_lr),
])
def test_broken_path_is_not_correct(which, fault, monkeypatch):
    cell = tiny.lm_cell() if which == "lm" else tiny.lr_cell()
    if fault is _proposal_altered_lm:
        cell = _with_sigma(cell, 1e-3)
        assert _run(cell)["correct"]  # sound at that step before the fault
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("which,number,sigma", [("lm", "lm.ll", 1e-2), ("lm", "lm.propose", 1e-3),
                                                ("lr", "lr.mu", None)])
def test_control_reads_above_the_program(which, number, sigma):
    cell = tiny.lm_cell() if which == "lm" else tiny.lr_cell()
    if sigma is not None:  # a step large enough that the tiny model's weights move
        cell = _with_sigma(cell, sigma)
    program = _run(cell)["checks"][number]["value"]
    control = spec.driver_module(cell.driver).control(cell, SEED, CPU, 0.3)[number]
    assert control > 3 * program, (control, program)
