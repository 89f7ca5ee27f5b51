"""Alg. 3: the sublinear-time subsampled MH transition.

The port of ``repro.core.subsampled_mh``. Local sections are evaluated only
when the sequential test asks for another mini-batch, so a transition costs
O(m * rounds) with rounds set by the test.

Randomness comes from one ``torch.Generator`` per chain (or per ensemble),
drawn in the reference's order: u, then the proposal's noise, then the
sampler's. The per-transition knobs (``epsilon``, the effective batch
``batch_eff``) may be per-chain tensors from the adaptive scheduler
(:mod:`repro_torch.core.schedule`) in place of the config's scalars.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .._device import resolve_device, tree_leaves, tree_select
from .proposals import propose
from .samplers import make_bounded_draw, make_sampler
from .sequential_test import sequential_test
from .target import PartitionedTarget

Params = Any


class SubsampledMHInfo(NamedTuple):
    accepted: torch.Tensor  # bool
    n_evaluated: torch.Tensor  # int32: sections actually evaluated
    rounds: torch.Tensor  # int32: mini-batches drawn
    mu_hat: torch.Tensor  # f32
    mu0: torch.Tensor  # f32
    pvalue: torch.Tensor  # f32
    log_u: torch.Tensor  # f32
    epsilon: torch.Tensor  # f32: tolerance this transition ran with
    batch_eff: torch.Tensor  # int32: mini-batch size this transition


@dataclasses.dataclass(frozen=True)
class SubsampledMHConfig:
    """Static configuration of one subsampled-MH chain.

    ``batch_size`` (m) sections per round; ``epsilon`` the test's p-value
    tolerance; ``max_rounds`` caps the test (default: enough rounds to
    exhaust the pool); ``sampler`` is "fy" (Fisher–Yates) or "stream".

        >>> cfg = SubsampledMHConfig(batch_size=50, epsilon=0.05)
        >>> cfg.batch_size, cfg.sampler
        (50, 'fy')
    """

    batch_size: int = 100
    epsilon: float = 0.01
    max_rounds: int | None = None
    sampler: str = "fy"


def draw_log_u(gen: torch.Generator, shape, device) -> torch.Tensor:
    """log u with u ~ U[1e-20, 1), float32 (the reference's floor)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return torch.log(torch.clamp_min(u, 1e-20))


def propose_and_mu0(gen: torch.Generator, theta: Params, target: PartitionedTarget,
                    proposal, prop_scale=None, *, batch_shape=()):
    """Steps 2-6 of Alg. 3: draw u, propose, evaluate the global section.
    Returns ``(theta_prime, mu0, log_u)``; ``batch_shape`` is (K,) for a
    batch of chains."""
    dev = tree_leaves(theta)[0].device
    log_u = draw_log_u(gen, batch_shape, dev)
    theta_p, corr = propose(proposal, gen, theta, prop_scale, batch_ndim=len(batch_shape))
    g = target.log_global(theta, theta_p) + corr
    mu0 = (log_u - g) / target.num_sections
    return theta_p, mu0, log_u


def finish_transition(gen, theta, theta_p, mu0, log_u, sampler_state, target, config,
                      reset_fn, draw_fn, *, eval_fn=None, epsilon=None, batch_eff=None,
                      draw_bounded_fn=None, batch_max: int | None = None,
                      max_rounds: int | None = None, mode: str = "auto"):
    """Steps 7-19 of Alg. 3 for a given proposal: the sequential test with
    lazily evaluated local sections, then accept or keep. Returns
    ``(theta', sampler', info)``. ``eval_fn`` defaults to the target's
    single-chain round, bound once for this pair
    (:meth:`~repro_torch.core.target.PartitionedTarget.local_round`).
    ``epsilon``, ``batch_eff`` (with its ``draw_bounded_fn``), ``batch_max``
    (the round shape, default ``config.batch_size``) and ``max_rounds`` are
    the scheduler's overrides, as in :func:`subsampled_mh_step`."""
    eps = config.epsilon if epsilon is None else epsilon
    if eval_fn is None:
        eval_fn = target.local_round(theta, theta_p, mode=mode)
    res = sequential_test(
        gen, mu0, draw_fn, eval_fn, reset_fn(sampler_state), target.num_sections,
        config.batch_size if batch_max is None else batch_max, eps,
        max_rounds=config.max_rounds if max_rounds is None else max_rounds,
        mode=mode, batch_eff=batch_eff, draw_bounded_fn=draw_bounded_fn,
    )
    accept = res.decision
    theta_new = tree_select(accept, theta_p, theta)
    f32 = dict(dtype=torch.float32, device=mu0.device)
    info = SubsampledMHInfo(
        accepted=accept,
        n_evaluated=res.n_evaluated,
        rounds=res.rounds,
        mu_hat=res.mu_hat,
        mu0=mu0,
        pvalue=res.pvalue,
        log_u=log_u,
        epsilon=torch.broadcast_to(torch.as_tensor(eps, **f32), mu0.shape),
        batch_eff=torch.broadcast_to(torch.as_tensor(
            config.batch_size if batch_eff is None else batch_eff, dtype=torch.int32,
            device=mu0.device), mu0.shape),
    )
    return theta_new, res.sampler_state, info


def subsampled_mh_step(gen: torch.Generator, theta: Params, sampler_state,
                       target: PartitionedTarget, proposal, config: SubsampledMHConfig,
                       reset_fn, draw_fn, *, epsilon=None, batch_eff=None,
                       draw_bounded_fn=None, max_rounds: int | None = None,
                       batch_max: int | None = None, prop_scale=None, mode: str = "auto"):
    """One approximate MH transition (Alg. 3). Returns (theta', sampler', info).

    Steps: 2 sample u; 3-4 evaluate the global section; 6 compute mu0; 7-14
    the sequential test; 15-19 accept or restore.

    The keyword overrides take the adaptive scheduler's per-chain knobs:
    ``epsilon`` replaces ``config.epsilon``; ``batch_eff`` (with its
    ``draw_bounded_fn``, :func:`repro_torch.core.samplers.make_bounded_draw`)
    caps each round at an effective batch while shapes stay at ``batch_max``
    (the largest bucket; default ``config.batch_size``); ``max_rounds`` must
    then cover exhaustion at the smallest bucket; ``prop_scale`` goes to the
    proposal's ``scale``.
    """
    theta_p, mu0, log_u = propose_and_mu0(gen, theta, target, proposal, prop_scale)
    return finish_transition(gen, theta, theta_p, mu0, log_u, sampler_state, target,
                             config, reset_fn, draw_fn, epsilon=epsilon, batch_eff=batch_eff,
                             draw_bounded_fn=draw_bounded_fn, batch_max=batch_max,
                             max_rounds=max_rounds, mode=mode)


def adaptive_max_rounds(config: SubsampledMHConfig, num_sections: int, buckets) -> int:
    """Static round cap covering pool exhaustion at the smallest bucket."""
    if config.max_rounds is not None:
        return config.max_rounds
    m_min = max(1, min(int(b) for b in buckets))
    return int(math.ceil(num_sections / m_min))


def make_kernel(target: PartitionedTarget, proposal, config: SubsampledMHConfig | None = None,
                *, scheduled: bool = False, batch_max: int | None = None, device=None):
    """Bundle an ``(init_state, step)`` pair:
    ``step(gen, theta, sampler_state) -> (theta', sampler_state', info)``.
    The sampler lives on ``device``, by default the target's device (or the
    card, for a hand-wired target).

    With ``scheduled=True`` the step is ``step(gen, theta, sampler_state,
    epsilon, batch_eff, max_rounds=None, prop_scale=None)`` and takes the
    adaptive controller's knobs (:func:`repro_torch.core.schedule
    .controller_params`); ``batch_max`` sets the round shape (the largest
    bucket: without it no bucket above ``config.batch_size`` is drawn)."""
    config = config or SubsampledMHConfig()
    device = device if device is not None else (target.device or resolve_device(None))
    state0, reset_fn, draw_fn = make_sampler(config.sampler, target.num_sections, device=device)

    if scheduled:
        draw_bounded = make_bounded_draw(config.sampler)

        def scheduled_step(gen, theta, sampler_state, epsilon, batch_eff, max_rounds=None,
                           prop_scale=None):
            return subsampled_mh_step(gen, theta, sampler_state, target, proposal, config,
                                      reset_fn, draw_fn, epsilon=epsilon, batch_eff=batch_eff,
                                      draw_bounded_fn=draw_bounded, max_rounds=max_rounds,
                                      batch_max=batch_max, prop_scale=prop_scale)

        return state0, scheduled_step

    def step(gen, theta, sampler_state):
        return subsampled_mh_step(gen, theta, sampler_state, target, proposal, config,
                                  reset_fn, draw_fn)

    return state0, step
