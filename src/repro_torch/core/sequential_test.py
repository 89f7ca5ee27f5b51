"""Alg. 2: the sequential Student-t test for the MH accept decision.

The port of ``repro.core.sequential_test``. Given u ~ U[0,1], accept iff
mu > mu0, where mu0 = (log u - sum_{global} log w_n) / N and mu is the mean
of the N local-section deltas l_i. The test draws mini-batches of l_i without
replacement, keeps a Welford accumulator, applies the finite-population
correction, and stops when the two-sided t p-value drops below epsilon, or
when the pool is exhausted (then the decision is exact). When s_l = 0 no
test is made and another batch is drawn.

One function serves one chain (mu0 of shape ()) and K chains in lock-step
(mu0 of shape (K,)): each round is one draw, one (K, m) evaluation and one
round op (:func:`repro_torch.kernels.ops.t_test_round`: merge, stopping rule
and bookkeeping, a single launch on the card). The reference's
``lax.while_loop`` becomes a Python loop that reads ``done`` on the host
once per round.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..kernels import ops, ref
from ..obs.trace import span
from .stats import Welford


def test_round_decision(welford: Welford, mu0, n_total, epsilon):
    """One round's stopping logic on the running accumulator (Alg. 2 steps
    7-14). Returns ``(decision, pvalue, test_ok, exhausted)``. The one
    definition of the rule: the round op's plain version calls the same
    float32 arithmetic (:func:`repro_torch.kernels.ref.round_decision_ref`)
    and its CUDA kernel repeats it operation for operation."""
    return ref.round_decision_ref(welford.count, welford.mean, welford.m2, mu0,
                                  n_total, epsilon)


class SeqTestResult(NamedTuple):
    decision: torch.Tensor  # bool: True = H1 (mu > mu0) = accept
    n_evaluated: torch.Tensor  # int32: local sections actually evaluated
    rounds: torch.Tensor  # int32: mini-batches drawn
    mu_hat: torch.Tensor  # f32
    pvalue: torch.Tensor  # f32 (final)
    sampler_state: tuple  # threaded sampler state
    aux: Any = ()  # threaded evaluator state (e.g. the LM's log-likelihood cache)


def sequential_test(
    gen: torch.Generator | None,
    mu0: torch.Tensor,
    draw_fn: Callable,
    eval_fn: Callable[[torch.Tensor], torch.Tensor],
    sampler_state,
    num_sections,
    batch_size: int,
    epsilon,
    max_rounds: int | None = None,
    *,
    mode: str = "auto",
    batch_eff=None,
    draw_bounded_fn: Callable | None = None,
    aux=None,
) -> SeqTestResult:
    """Run the sequential test for one chain (mu0 shape ()) or K lock-step
    chains (mu0 shape (K,)).

    draw_fn(gen, sampler_state, m, active, mode=) -> (sampler_state, idx, valid)
    eval_fn(idx) -> l, shaped mu0.shape + (m,)

    ``epsilon`` is a float or a per-chain tensor; ``mode`` is the kernel
    dispatch of the draw and the round op. ``num_sections`` is the pool
    size N, an int or an int tensor shaped () or like ``mu0`` (each chain's
    own N, as the DP mixture's w move has); a tensor needs an explicit
    ``max_rounds``, since the round cap is a number the host knows. With
    ``batch_eff`` (an effective batch <= ``batch_size``, () or per chain) and its
    ``draw_bounded_fn(gen, state, m_max, m_eff, active, mode=)``, rounds keep
    the shape ``batch_size`` but only ``batch_eff`` sections a chain are
    drawn, merged and consumed: the adaptive scheduler's buckets. Pass a
    ``max_rounds`` that covers exhaustion at the smallest bucket then.

    With ``aux`` the evaluator is stateful: ``eval_fn(idx, aux) -> (l, aux)``,
    and the result carries the final ``aux`` (the lazy log-likelihood cache
    of :func:`repro_torch.bayes.make_cached_train_step` rides on it).

    Example — an easy decision (all l_i far above mu0) stops after one round::

        >>> import torch
        >>> from repro_torch.core import make_sampler, sequential_test
        >>> state0, reset, draw = make_sampler("stream", 1000, device="cpu")
        >>> res = sequential_test(
        ...     None, mu0=torch.tensor(-1.0), draw_fn=draw,
        ...     eval_fn=lambda idx: idx.float(), sampler_state=reset(state0),
        ...     num_sections=1000, batch_size=50, epsilon=0.05)
        >>> bool(res.decision), int(res.rounds), int(res.n_evaluated)
        (True, 1, 50)
    """
    if batch_eff is not None and draw_bounded_fn is None:
        raise ValueError("batch_eff requires a matching draw_bounded_fn")
    per_chain = isinstance(num_sections, torch.Tensor)
    if max_rounds is None:
        if per_chain:
            raise ValueError("num_sections is a tensor (a per-chain pool size); pass an "
                             "explicit max_rounds")
        max_rounds = int(math.ceil(num_sections / batch_size))
    mu0 = mu0.to(torch.float32).contiguous()
    shape, dev = mu0.shape, mu0.device
    f32 = dict(dtype=torch.float32, device=dev)
    n_total = num_sections
    if per_chain:  # the round op's (K,) float32 pool sizes
        n_total = torch.broadcast_to(num_sections.to(**f32), shape).reshape(-1).contiguous()
    w = Welford.empty(shape, device=dev)
    rounds = torch.zeros(shape, dtype=torch.int32, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    decision = torch.zeros(shape, dtype=torch.bool, device=dev)
    pval = torch.ones(shape, **f32)
    eps = torch.broadcast_to(torch.as_tensor(epsilon, **f32), shape).contiguous()
    flat = lambda t: t.view(-1)  # (K,) views of the state: () becomes (1,)
    sampler = sampler_state
    batched = len(shape) > 0
    r, finished = 0, False
    while not finished:
        with span("test.round", "round", round=r):
            active = ~done if batched else None
            if batch_eff is None:
                sampler, idx, valid = draw_fn(gen, sampler, batch_size, active, mode=mode)
            else:
                sampler, idx, valid = draw_bounded_fn(gen, sampler, batch_size, batch_eff,
                                                      active, mode=mode)
            if aux is None:
                l = eval_fn(idx)
            else:
                l, aux = eval_fn(idx, aux)
            ops.t_test_round(
                l.reshape(-1, batch_size), valid.reshape(-1, batch_size),
                flat(w.count), flat(w.mean), flat(w.m2), flat(mu0), flat(eps),
                n_total, max_rounds, flat(rounds), flat(done), flat(decision),
                flat(pval), mode=mode,
            )
            finished = bool(done.all())
        r += 1
    return SeqTestResult(
        decision=decision,
        n_evaluated=w.count.to(torch.int32),
        rounds=rounds,
        mu_hat=w.mean,
        pvalue=pval,
        sampler_state=sampler,
        aux=() if aux is None else aux,
    )


def expected_batches_theoretical(l_values, mu0: float, batch_size: int, epsilon: float) -> float:
    """Host-side expectation of the sections evaluated for a fixed (theta,
    theta') pair, after Korattikara et al. (2014) Eq. 19: the test walked
    forward on the population moments (mean and std of {l_i}) instead of
    draws. The theory curve of Fig. 5; host numpy and scipy, as in the
    reference."""
    import numpy as np
    from scipy import stats as sstats

    l = np.asarray(l_values, np.float64)
    n_total = len(l)
    mu = l.mean()
    sl = l.std(ddof=1)
    if sl == 0:
        return float(n_total)
    p_not_stopped = 1.0
    expected = 0.0
    n = 0
    while n < n_total and p_not_stopped > 1e-12:
        m = min(batch_size, n_total - n)
        n += m
        expected += m * p_not_stopped
        corr = max(1.0 - (n - 1) / max(n_total - 1, 1), 0.0)
        s = sl / math.sqrt(n) * math.sqrt(corr)
        if s == 0:
            break
        t = abs(mu - mu0) / s
        pval = 2.0 * sstats.t.sf(t, df=max(n - 1, 1))
        # the test statistic concentrates fast, so the stop is ~deterministic at each n
        p_not_stopped *= 1.0 - (1.0 if pval < epsilon else 0.0)
    return float(expected)
