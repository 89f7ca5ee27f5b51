"""Sequential Monte Carlo for one series: bootstrap particle filter and
conditional SMC (particle Gibbs), the port of ``repro.inference.smc``.

Plain PyTorch; the single-series twin of the fused sweep
(:mod:`repro_torch.kernels.pgibbs`) and the sweep behind the stochvol
cycle's ``sweep="opaque"``. The model is a pair of callables over the whole
particle vector (the reference maps scalar callables over particles; here
the particle axis is written out):

  transition_sample(gen, h_prev (P,), t, params) -> h_t (P,)   (proposal = prior)
  obs_logpdf(x_t, h_t (P,), t, params)           -> logp (P,)  (weights)

Resampling is the reference's: conditional multinomial by Gumbel-max for
particle Gibbs, systematic for the filter, with uniforms from ``gen``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class SMCResult(NamedTuple):
    trajectory: torch.Tensor  # (T,) sampled path
    log_evidence: torch.Tensor  # scalar SMC marginal-likelihood estimate


def _categorical(gen: torch.Generator, logw: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Gumbel-max draws from softmax(logw): n of them (shape (n,)), or one."""
    shape = (logw.shape[-1],) if n is None else (n, logw.shape[-1])
    u = torch.rand(shape, generator=gen, device=logw.device)
    return torch.argmax(logw - torch.log(-torch.log(u)), dim=-1)


def _systematic_resample(gen: torch.Generator, logw: torch.Tensor) -> torch.Tensor:
    """Systematic resampling; returns ancestor indices (P,)."""
    p = logw.shape[0]
    cum = torch.cumsum(torch.softmax(logw, dim=-1), dim=-1)
    u = (torch.rand((), generator=gen, device=logw.device)
         + torch.arange(p, device=logw.device)) / p
    return torch.clamp_max(torch.searchsorted(cum, u), p - 1)


def _trace_back(hs, ancs, b) -> torch.Tensor:
    out = [None] * len(hs)
    for t in range(len(hs) - 1, -1, -1):
        out[t] = hs[t][b]
        if t > 0:
            b = ancs[t - 1][b]
    return torch.stack(out)


def csmc(gen: torch.Generator, obs: torch.Tensor, ref_path: torch.Tensor, params,
         transition_sample: Callable, obs_logpdf: Callable, num_particles: int,
         h0: float = 0.0) -> SMCResult:
    """One conditional-SMC sweep with the reference path retained at slot 0.

    Multinomial conditional resampling (slot 0's ancestor pinned to 0) keeps
    the invariance property of particle Gibbs (Andrieu et al. 2010).
    """
    p = num_particles
    h_prev = torch.full((p,), h0, dtype=torch.float32, device=obs.device)
    hs, ancs, log_z = [], [], torch.zeros((), device=obs.device)
    logw = None
    for t in range(obs.shape[0]):
        h_t = transition_sample(gen, h_prev, t, params)
        h_t = torch.cat([ref_path[t:t + 1].to(h_t.dtype), h_t[1:]])  # the retained particle
        logw = obs_logpdf(obs[t], h_t, t, params)
        anc = _categorical(gen, logw, p)
        anc[0] = 0
        h_prev = h_t[anc]
        log_z = log_z + torch.logsumexp(logw, 0) - math.log(p)
        hs.append(h_t)
        ancs.append(anc)
    b = _categorical(gen, logw)
    return SMCResult(_trace_back(hs, ancs, b), log_z)


def particle_filter(gen: torch.Generator, obs: torch.Tensor, params,
                    transition_sample: Callable, obs_logpdf: Callable, num_particles: int,
                    h0: float = 0.0) -> SMCResult:
    """Bootstrap particle filter (unconditional): used to initialize
    particle Gibbs."""
    p = num_particles
    h_prev = torch.full((p,), h0, dtype=torch.float32, device=obs.device)
    hs, ancs, log_z = [], [], torch.zeros((), device=obs.device)
    logw = None
    for t in range(obs.shape[0]):
        h_t = transition_sample(gen, h_prev, t, params)
        logw = obs_logpdf(obs[t], h_t, t, params)
        anc = _systematic_resample(gen, logw)
        h_prev = h_t[anc]
        log_z = log_z + torch.logsumexp(logw, 0) - math.log(p)
        hs.append(h_t)
        ancs.append(anc)
    b = _categorical(gen, logw)
    return SMCResult(_trace_back(hs, ancs, b), log_z)
