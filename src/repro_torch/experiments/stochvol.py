"""Stochastic volatility (paper Sec. 4.3), the port of
``repro.experiments.stochvol``.

    x_t = exp(h_t / 2) eps_t,   h_t ~ N(phi h_{t-1}, sigma^2),  h_0 = 0
    phi ~ Beta(5, 1),           sigma^2 ~ InvGamma(5, 0.05)

Joint parameter and state estimation: particle Gibbs samples the latent
paths h while subsampled MH samples phi and sigma^2. The local sections of
both parameters are the S*T transition factors N(h_t | phi h_{t-1},
sigma^2) of the current paths: statistically dependent sections, the case
that sets the paper apart from iid austerity (Sec. 3.2 Remark).

Data is drawn on the device from a seeded ``torch.Generator``; to start from
the JAX package's arrays use :mod:`repro_torch.convert`. Entry points take
``device=None`` (the card; raises without one). ``make_serving_workload``
serves the posterior through :mod:`repro_torch.serving`.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .._device import make_generator, resolve_device
from ..core.composite import CycleOp, SubsampledMHOp, SweepOp, cycle, run_cycle_sequential
from ..core.ensemble import ChainEnsemble
from ..core.stats import split_rhat
from ..core.subsampled_mh import SubsampledMHConfig
from ..core.target import PartitionedTarget
from ..core.target_builder import build_target
from ..inference.smc import csmc
from ..kernels import ref
from ..kernels.pgibbs import COMPAT_REASON, batched_pgibbs_sweep, pgibbs_sweep_fused

#: Sweep implementations for :func:`make_inference_cycle`:
#: "fused"  the fused sweep kernel (repro_torch.kernels.pgibbs);
#: "compat" the reference's bit-for-bit replay of JAX's key stream, which
#:          PyTorch cannot give (raises NotImplementedError);
#: "opaque" the per-series conditional SMC (repro_torch.inference.smc).
SWEEP_MODES = ("fused", "compat", "opaque")
SWEEP_ENV_VAR = "REPRO_SWEEP"


def resolve_sweep(sweep: str = "auto") -> str:
    """``auto`` defers to ``$REPRO_SWEEP`` and defaults to ``fused``."""
    if sweep == "auto":
        sweep = os.environ.get(SWEEP_ENV_VAR, "fused")
    if sweep not in SWEEP_MODES:
        raise ValueError(f"unknown sweep mode {sweep!r}; expected 'auto' or one of {SWEEP_MODES}")
    return sweep


class SVParams(NamedTuple):
    phi: torch.Tensor  # in (0, 1)
    sigma2: torch.Tensor  # > 0


class SVData(NamedTuple):
    obs: torch.Tensor  # (S, T) observations
    h_true: torch.Tensor  # (S, T) latent paths


def synth(seed=0, num_series: int = 200, length: int = 5, phi: float = 0.95,
          sigma: float = 0.1, *, device=None) -> SVData:
    """S independent series of length T from the model at (phi, sigma)."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    eps_h = torch.randn((num_series, length), generator=gen, device=dev) * sigma
    eps_x = torch.randn((num_series, length), generator=gen, device=dev)
    cols, h_prev = [], torch.zeros(num_series, device=dev)
    for t in range(length):
        h_prev = phi * h_prev + eps_h[:, t]
        cols.append(h_prev)
    h = torch.stack(cols, dim=1)
    return SVData(obs=torch.exp(h / 2.0) * eps_x, h_true=h)


# -- densities ---------------------------------------------------------------


def log_prior_phi(phi):
    """Beta(5, 1) on phi; -inf outside (0, 1)."""
    inside = (phi > 0) & (phi < 1)
    lp = 4.0 * torch.log(torch.clamp(phi, 1e-12, 1.0)) + math.log(5.0)
    return torch.where(inside, lp, torch.full_like(lp, -math.inf))


def log_prior_sigma2(s2):
    """InvGamma(5, 0.05) on sigma^2; -inf for sigma^2 <= 0."""
    a, b = 5.0, 0.05
    s2c = torch.clamp_min(s2, 1e-12)
    lp = (a * math.log(b) - math.lgamma(a)) - (a + 1) * torch.log(s2c) - b / s2c
    return torch.where(s2 > 0, lp, torch.full_like(lp, -math.inf))


def _trans_logpdf(h_t, h_prev, phi, sigma2):
    s2 = torch.clamp_min(torch.as_tensor(sigma2, dtype=torch.float32), ref.S2_FLOOR)
    z2 = (h_t - phi * h_prev) ** 2 / s2
    return -0.5 * (z2 + torch.log(s2) + ref.LOG2PI)


def _obs_logpdf(x_t, h_t):
    """x_t ~ N(0, exp(h_t)): the one definition the sweep weights with."""
    return ref.sv_obs_loglik(x_t, h_t)


# -- partitioned targets ------------------------------------------------------


def _sv_prior(theta):
    return log_prior_phi(theta["phi"]) + log_prior_sigma2(theta["sigma2"])


def _sv_params(theta):
    return theta["phi"], theta["sigma2"]


def _permutation(permute_key, n: int, device):
    """None, an explicit permutation of n sections (array or tensor), or an
    int seed / generator that draws one."""
    if permute_key is None:
        return None
    if isinstance(permute_key, (int, torch.Generator)):
        gen = make_generator(permute_key, device)
        return torch.randperm(n, generator=gen, device=device)
    perm = torch.as_tensor(np.array(permute_key), dtype=torch.long, device=device)
    if perm.shape != (n,):
        raise ValueError(f"permutation has shape {tuple(perm.shape)}, expected ({n},)")
    return perm


def _sections(h: torch.Tensor, n: int, perm):
    """(xt, xp): each transition factor's h_t and h_{t-1} (h_0 = 0), flat
    over (series, t), over the last two axes of h (S, T) or (K, S, T)."""
    h_prev = torch.cat([torch.zeros_like(h[..., :1]), h[..., :-1]], dim=-1)
    xt, xp = h.reshape(h.shape[:-2] + (n,)), h_prev.reshape(h.shape[:-2] + (n,))
    if perm is not None:
        xt, xp = xt[..., perm], xp[..., perm]
    return xt.contiguous(), xp.contiguous()


def make_param_target(h: torch.Tensor, which: str, permute_key=None) -> PartitionedTarget:
    """Target over ``params = {phi, sigma2}`` with h fixed: local sections are
    all (series, t) transition factors of h (S, T), through the
    ``gaussian_ar1`` kernel family. ``which`` names the moving parameter;
    both share the section structure. ``permute_key`` pre-permutes the
    section order once, so the ``stream`` sampler's contiguous slices are
    valid without-replacement draws although the sections are serially
    correlated in natural order."""
    del which
    s, t_len = h.shape
    n = s * t_len
    pools = _sections(h.to(torch.float32), n, _permutation(permute_key, n, h.device))
    return build_target("gaussian_ar1", pools, n, prior_logpdf=_sv_prior, params_fn=_sv_params)


def make_joint_param_target(num_series: int, length: int, permute_key=None, *,
                            device=None) -> PartitionedTarget:
    """The ensemble-ready form of :func:`make_param_target`: the paths live
    in ``theta["h"]``, so one target serves every chain (each chain's
    sections derive from its own paths, (K, N) pools) and the sweep can
    update h between MH moves. The pools are built once per MH transition;
    the phi / sigma^2 proposals never move ``h``."""
    dev = resolve_device(device)
    n = num_series * length
    perm = _permutation(permute_key, n, dev)
    return build_target("gaussian_ar1", lambda theta: _sections(theta["h"], n, perm), n,
                        prior_logpdf=_sv_prior, params_fn=_sv_params, device=dev)


class SingleLeafRW:
    """Symmetric random walk on one dict leaf, the others untouched (the
    paper's per-variable ``subsampled_mh sig/phi`` kernels)."""

    def __init__(self, leaf: str, sigma: float):
        self.leaf, self.sigma = leaf, sigma

    def __call__(self, gen: torch.Generator, theta):
        x = theta[self.leaf]
        noise = torch.randn(x.shape, generator=gen, device=x.device)
        theta_p = dict(theta)
        theta_p[self.leaf] = x + self.sigma * noise
        return theta_p, torch.zeros((), dtype=torch.float32, device=x.device)


# -- particle Gibbs over latent paths -----------------------------------------


def pgibbs_sweep(gen: torch.Generator, obs: torch.Tensor, h: torch.Tensor, params: SVParams,
                 num_particles: int = 30) -> torch.Tensor:
    """One conditional-SMC sweep per series, series after series (the
    opaque path): returns new h (S, T)."""

    def transition_sample(g, h_prev, t, p):
        del t
        noise = torch.randn(h_prev.shape, generator=g, device=h_prev.device)
        return ref.ar1_propagate(h_prev, noise, p.phi, p.sigma2)

    def obs_logpdf(x_t, h_t, t, p):
        del t, p
        return _obs_logpdf(x_t, h_t)

    return torch.stack([csmc(gen, obs[i], h[i], params, transition_sample, obs_logpdf,
                             num_particles).trajectory for i in range(obs.shape[0])])


# -- the paper's inference program on the ensemble engine ---------------------


def make_inference_cycle(obs: torch.Tensor, *, batch_size: int = 100, epsilon: float = 0.05,
                         sigma_phi: float = 0.02, sigma_sig: float = 0.003,
                         num_particles: int = 25, sampler: str = "fy", permute_key=None,
                         sweep: str = "auto") -> CycleOp:
    """The paper's Sec-4.3 program as a composite cycle:

        [infer (cycle ((pgibbs h ...) (subsampled_mh phi ...)
                       (subsampled_mh sig ...)) 1)]

    one particle-Gibbs sweep over the latent paths, then per-variable
    subsampled-MH moves on phi and sigma^2 whose local sections are the
    transition factors of the current paths (``theta["h"]``). The same cycle
    drives :func:`run_posterior_sequential` and the K-chain
    :func:`run_posterior_ensemble`. Everything lives on ``obs``'s device.
    """
    s, t_len = obs.shape
    target = make_joint_param_target(s, t_len, permute_key, device=obs.device)
    cfg = SubsampledMHConfig(batch_size=batch_size, epsilon=epsilon, sampler=sampler)
    sweep = resolve_sweep(sweep)
    if sweep == "compat":
        raise NotImplementedError(COMPAT_REASON)
    if sweep == "opaque":
        def pg_sweep(gen, theta):
            h = pgibbs_sweep(gen, obs, theta["h"], SVParams(theta["phi"], theta["sigma2"]),
                             num_particles)
            return {**theta, "h": h}

        sweep_op = SweepOp(pg_sweep, name="pgibbs")
    else:
        def pg_single(gen, theta):
            h = pgibbs_sweep_fused(gen, obs, theta["h"], theta["phi"], theta["sigma2"],
                                   num_particles=num_particles)
            return {**theta, "h": h}

        def pg_batched(gen, theta):
            h = batched_pgibbs_sweep(gen, obs, theta["h"], theta["phi"], theta["sigma2"],
                                     num_particles=num_particles)
            return {**theta, "h": h}

        sweep_op = SweepOp(pg_single, name="pgibbs", batched_fn=pg_batched)
    return cycle([
        sweep_op,
        SubsampledMHOp(target, SingleLeafRW("phi", sigma_phi), cfg, name="phi"),
        SubsampledMHOp(target, SingleLeafRW("sigma2", sigma_sig), cfg, name="sigma2"),
    ])


def init_theta(obs: torch.Tensor, phi: float = 0.7, sigma2: float = 0.03) -> dict:
    return {
        "phi": torch.tensor(phi, dtype=torch.float32, device=obs.device),
        "sigma2": torch.tensor(sigma2, dtype=torch.float32, device=obs.device),
        "h": torch.zeros_like(obs),
    }


def _collect_params(theta):
    return {"phi": theta["phi"], "sigma2": theta["sigma2"]}


def run_posterior_sequential(seed, data: SVData, num_steps: int = 400, *, theta0: dict | None = None,
                             collect=None, device=None, **cycle_kw):
    """Single-chain run of the joint pgibbs + subsampled-MH program. Returns
    ``(theta_final, samples, infos)``: ``samples`` the collected (phi,
    sigma2) trace, ``infos`` keyed by component."""
    dev = resolve_device(device)
    obs = data.obs.to(dev)
    cyc = make_inference_cycle(obs, **cycle_kw)
    theta0 = theta0 if theta0 is not None else init_theta(obs)
    return run_cycle_sequential(seed, theta0, cyc, num_steps, collect or _collect_params,
                                device=dev)


def run_posterior_ensemble(seed, data: SVData, num_chains: int = 4, num_steps: int = 400, *,
                           theta0: dict | None = None, collect=None, fused_kernels: str = "auto",
                           device=None, **cycle_kw):
    """K-chain stochastic-volatility posterior on the lock-step engine.

    The cycle advances every chain's (h, phi, sigma2); the sweep is one
    kernel launch for all chains, and the phi / sigma^2 rounds evaluate
    (K, m) blocks. An ensemble of one chain reproduces
    :func:`run_posterior_sequential` with the same seed.

        >>> from repro_torch.experiments import stochvol
        >>> data = stochvol.synth(0, num_series=8, length=5, device="cpu")
        >>> _, samples, infos, diag = stochvol.run_posterior_ensemble(
        ...     1, data, num_chains=2, num_steps=8, batch_size=10,
        ...     num_particles=4, device="cpu")
        >>> tuple(samples["phi"].shape), sorted(diag["frac_evaluated"])
        ((2, 8), ['phi', 'sigma2'])

    Returns ``(state, samples, infos, diagnostics)``: ``samples`` maps
    "phi"/"sigma2" to (K, T) traces; ``diagnostics`` has split R-hat over
    the second half per leaf, the evaluated-section fraction and per-chain
    acceptance per MH variable.
    """
    dev = resolve_device(device)
    obs = data.obs.to(dev)
    cyc = make_inference_cycle(obs, **cycle_kw)
    ens = ChainEnsemble(num_chains=num_chains, transition=cyc, collect=collect or _collect_params,
                        fused_kernels=fused_kernels, device=dev)
    theta0 = theta0 if theta0 is not None else init_theta(obs)
    state, samples, infos = ens.run(seed, ens.init(theta0), num_steps)
    n = obs.numel()
    half = num_steps // 2
    as_np = lambda t: t.detach().cpu().numpy().astype(np.float64)
    diagnostics = {
        "rhat_phi": split_rhat(as_np(samples["phi"])[:, half:]),
        "rhat_sigma2": split_rhat(as_np(samples["sigma2"])[:, half:]),
        "frac_evaluated": {name: float(as_np(infos[name].n_evaluated).mean() / n)
                           for name in ("phi", "sigma2")},
        "accept_rate": {name: as_np(infos[name].accepted).mean(axis=1)
                        for name in ("phi", "sigma2")},
    }
    return state, samples, infos, diagnostics


def stationary_vol(theta) -> torch.Tensor:
    """The stationary log-volatility scale sigma / sqrt(1 - phi^2), per draw."""
    s2 = torch.clamp_min(theta["sigma2"], 1e-12)
    one_minus = torch.clamp_min(1.0 - theta["phi"] ** 2, 1e-6)
    return torch.sqrt(s2 / one_minus)


def make_serving_workload(*, smoke: bool = False, num_chains: int = 4,
                          num_series: int | None = None, length: int | None = None,
                          num_particles: int | None = None, batch_size: int = 100,
                          epsilon: float = 0.05, seed: int = 0, device=None):
    """The stochastic-volatility posterior as a servable workload: the full
    Sec-4.3 composite cycle (particle Gibbs over paths + subsampled-MH
    phi/sigma2 moves) kept resident, with request classes

      * ``vol_quantile``: posterior quantiles of the stationary log-vol
        scale ``sigma / sqrt(1 - phi^2)``; request rows are quantile levels
        in (0, 1),
      * ``phi_mean``: the posterior-mean persistence (rows are dummy
        levels; every row returns the same scalar functional).
    """
    from ..serving.resident import QuerySpec
    from ..serving.workloads import ServingWorkload, level_sampler

    dev = resolve_device(device)
    num_series = num_series if num_series is not None else (40 if smoke else 200)
    length = length if length is not None else (6 if smoke else 10)
    num_particles = num_particles if num_particles is not None else (10 if smoke else 25)
    data = synth(seed, num_series=num_series, length=length, device=dev)
    cyc = make_inference_cycle(data.obs, batch_size=min(batch_size, num_series * length),
                               epsilon=epsilon, num_particles=num_particles)
    ens = ChainEnsemble(num_chains=num_chains, transition=cyc, collect=_collect_params,
                        device=dev)
    per_row = lambda v, xs: v[:, None].expand(-1, xs.shape[0])  # (S,) -> (S, B)
    specs = {
        "vol_quantile": QuerySpec(fn=lambda theta, xs: per_row(stationary_vol(theta), xs),
                                  aggregate="quantile", make_queries=level_sampler,
                                  name="vol_quantile"),
        "phi_mean": QuerySpec(fn=lambda theta, xs: per_row(theta["phi"], xs), aggregate="mean",
                              make_queries=level_sampler, name="phi_mean"),
    }
    return ServingWorkload(name="stochvol", ensemble=ens, theta0=init_theta(data.obs),
                           query_specs=specs, default_class="vol_quantile",
                           description=f"stochastic volatility, {num_series} series x {length}")


def exact_state_loglik(obs: torch.Tensor, h: torch.Tensor, params: SVParams) -> torch.Tensor:
    """Full joint log p(x, h | params): used in tests against brute force."""
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return (_trans_logpdf(h, h_prev, params.phi, params.sigma2).sum()
            + _obs_logpdf(obs, h).sum())
