"""One lock-step round of the sequential test for K chains, as one kernel.

Merges each chain's (m,) deltas into its Welford accumulator under the valid
mask, applies the stopping rule of
:func:`repro_torch.core.sequential_test.test_round_decision`, and advances the
round bookkeeping, for every chain whose test is not yet done. The state is
updated in place (the port's one in-place round, to keep a round to a single
launch with no new allocations):

  count, mean, m2, pval : (K,) f32      rounds : (K,) int32
  done, decision        : (K,) bool

The pool size ``n_total`` is one number for every chain or a (K,) float32
tensor, each chain's own (the DP mixture's w move tests over the N_k
members of a randomly chosen expert). A number gives the kernel a null
pointer and the bits of the scalar form.

The CUDA source is ``csrc/t_test_round.cu``; :func:`t_test_round_ref` is the
plain version, built from the float32 arithmetic in
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .ref import round_decision_ref, welford_merge_ref

NAME = "t_test_round"

__all__ = ["t_test_round", "t_test_round_ref"]


def t_test_round_ref(l, valid, count, mean, m2, mu0, eps, n_total, max_rounds,
                     rounds, done, decision, pval) -> None:
    """Plain version of :func:`t_test_round` (same in-place contract)."""
    active = ~done
    c2, mu2, q2 = welford_merge_ref(count, mean, m2, l, valid)
    dec, pv, test_ok, exhausted = round_decision_ref(c2, mu2, q2, mu0, n_total, eps)
    r2 = rounds + 1
    fin = test_ok | exhausted | (r2 >= max_rounds)
    count.copy_(torch.where(active, c2, count))
    mean.copy_(torch.where(active, mu2, mean))
    m2.copy_(torch.where(active, q2, m2))
    rounds.copy_(torch.where(active, r2, rounds))
    decision.copy_(torch.where(active, dec, decision))
    pval.copy_(torch.where(active, pv, pval))
    done.copy_(done | fin)


@functools.cache
def _bind():
    fn = _build.load("t_test_round").t_test_round
    P, I = _build.P, _build.I
    fn.argtypes = [P, P, I, I, P, P, P, P, P, _build.FL, P, I, P, P, P, P, P]
    fn.restype = I
    return fn


def t_test_round(l, valid, count, mean, m2, mu0, eps, n_total, max_rounds,
                 rounds, done, decision, pval) -> None:
    """l (K, m) f32 deltas, valid (K, m) bool; mu0, eps (K,) f32;
    ``n_total`` the pool size N (a number, or a (K,) f32 tensor of
    per-chain sizes), ``max_rounds`` the round cap. Updates the state
    tensors in place; returns nothing."""
    if l.device.type == "cpu":
        return t_test_round_ref(l, valid, count, mean, m2, mu0, eps, n_total,
                                max_rounds, rounds, done, decision, pval)
    if l.device.type != "cuda":
        raise ValueError(f"t_test_round has no kernel for device {l.device}")
    dev = l.device
    if l.ndim != 2:
        raise ValueError(f"l must be (K, m), got {tuple(l.shape)}")
    k, m = l.shape
    f32, vec = (torch.float32,), (k,)
    _build.require(l, "l", dev, f32, (k, m))
    _build.require(valid, "valid", dev, (torch.bool,), (k, m))
    for name, t in (("count", count), ("mean", mean), ("m2", m2), ("mu0", mu0),
                    ("eps", eps), ("pval", pval)):
        _build.require(t, name, dev, f32, vec)
    _build.require(rounds, "rounds", dev, (torch.int32,), vec)
    _build.require(done, "done", dev, (torch.bool,), vec)
    _build.require(decision, "decision", dev, (torch.bool,), vec)
    per_chain = isinstance(n_total, torch.Tensor)
    if per_chain:
        _build.require(n_total, "n_total", dev, f32, vec)
    p = _build.ptr
    err = _build.launch(_bind(), l.device,
        p(l), p(valid), k, m, p(count), p(mean), p(m2), p(mu0), p(eps), 0.0 if per_chain else
        float(n_total), p(n_total if per_chain else None), int(max_rounds), p(rounds), p(done),
        p(decision), p(pval), _build.stream_of(l))
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
