"""Proposal distributions for MH transitions.

The port of ``repro.core.proposals``. A proposal is called as
``proposal(gen, theta[, scale]) -> (theta_prime, log_correction)`` where

    log_correction = log q(theta | theta') - log q(theta' | theta)

and ``gen`` is the ``torch.Generator`` that draws the noise. Theta is a
tensor or a dict / tuple of tensors; with a leading (K,) chain axis the same
call proposes for K chains at once, and ``log_correction`` has shape (K,).
Callers go through :func:`propose`, which tells :class:`MALA` where the
chain axes end.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._device import tree_leaves, tree_map

Params = Any


def _randn_like(gen: torch.Generator, tree: Params) -> Params:
    return tree_map(
        lambda l: torch.randn(l.shape, generator=gen, dtype=l.dtype if l.is_floating_point()
                              else torch.float32, device=l.device), tree)


@dataclasses.dataclass(frozen=True)
class RandomWalk:
    """Symmetric Gaussian random walk: theta' = theta + sigma * xi.

    ``sigma`` is a scalar or a tree matching theta. Symmetric, so the log
    correction is a scalar 0 (it broadcasts against (K,) global terms).
    """

    sigma: Any = 0.1

    def __call__(self, gen: torch.Generator, theta: Params, scale=None):
        """``scale`` (an optional scalar or (K,) tensor) multiplies ``sigma``:
        the adaptive-proposal hook."""
        xi = _randn_like(gen, theta)
        sigma = self.sigma
        scalar_sigma = isinstance(sigma, (int, float)) or (
            isinstance(sigma, torch.Tensor) and sigma.ndim == 0)
        if scalar_sigma:
            sigma = tree_map(lambda _: sigma, theta)
        if scale is not None:
            def scaled(s, t):
                sc = torch.as_tensor(scale, device=t.device)
                return s * sc.reshape(sc.shape + (1,) * (t.ndim - sc.ndim))
            sigma = tree_map(scaled, sigma, theta)
        theta_p = tree_map(lambda t, n, s: t + s * n, theta, xi, sigma)
        leaf = tree_leaves(theta)[0]
        return theta_p, torch.zeros((), dtype=torch.float32, device=leaf.device)


@dataclasses.dataclass(frozen=True)
class MALA:
    """Metropolis-adjusted Langevin proposal from a (possibly stochastic)
    gradient estimate of the log target:

        theta' = theta + (step/2) * grad(theta) + sqrt(step) * xi

    with the q-correction computed from ``grad_fn`` at both points. When
    ``grad_fn`` is a subsampled estimate the correction is approximate; the
    sequential test still targets the exact ratio of p's.

    ``grad_fn(theta) -> tree like theta``. The reference vmaps the
    proposal over chains; here the caller says how many leading axes of
    each leaf are chains (``batch_ndim``: 0 for one chain, 1 for a (K, ...)
    batch), and the correction sums every other axis, so it is () for one
    chain and (K,) for a batch. :func:`propose` passes that count.
    """

    step: float
    grad_fn: Callable[[Params], Params]

    def __call__(self, gen: torch.Generator, theta: Params, *, batch_ndim: int = 0):
        g = self.grad_fn(theta)
        xi = _randn_like(gen, theta)
        half = 0.5 * self.step
        root = float(torch.sqrt(torch.tensor(self.step, dtype=torch.float32)))  # as float32
        theta_p = tree_map(lambda t, gg, n: t + half * gg + root * n, theta, g, xi)
        g_p = self.grad_fn(theta_p)

        def logq(dst, src, gsrc):
            # log N(dst; src + half * gsrc, step I) up to shared constants
            diff = tree_map(lambda d, s_, gg: d - s_ - half * gg, dst, src, gsrc)
            sq = sum(torch.square(l.to(torch.float32)).reshape(l.shape[:batch_ndim] + (-1,)).sum(-1)
                     for l in tree_leaves(diff))
            return -sq / (2.0 * self.step)

        return theta_p, logq(theta, theta_p, g_p) - logq(theta_p, theta, g)


def propose(proposal, gen: torch.Generator, theta: Params, scale=None, *, batch_ndim: int = 0):
    """``proposal(gen, theta[, scale])`` for a theta whose leading
    ``batch_ndim`` axes are chains. Only :class:`MALA` takes that count;
    the others need none (a symmetric walk's correction is a scalar 0, an
    independence proposal compares theta's rank with ``mu``'s)."""
    kw = {"batch_ndim": batch_ndim} if isinstance(proposal, MALA) else {}
    if scale is None:
        return proposal(gen, theta, **kw)
    return proposal(gen, theta, scale, **kw)


@dataclasses.dataclass(frozen=True)
class IndependentGaussian:
    """Independence proposal q(theta') = N(mu, sigma^2 I); the correction is
    the full ratio. Theta with one more axis than ``mu`` is a batch of
    chains."""

    mu: Any
    sigma: float = 1.0

    def __call__(self, gen: torch.Generator, theta: Params):
        batched = tree_leaves(theta)[0].ndim > torch.as_tensor(tree_leaves(self.mu)[0]).ndim
        xi = _randn_like(gen, theta)
        theta_p = tree_map(lambda m, n: m + self.sigma * n, self.mu, xi)

        def logq(x):
            diff = tree_map(lambda a, m: a - m, x, self.mu)
            sq = sum((torch.square(l.to(torch.float32)).flatten(1).sum(1) if batched
                      else torch.square(l.to(torch.float32)).sum())
                     for l in tree_leaves(diff))
            return -sq / (2.0 * self.sigma ** 2)

        return theta_p, logq(theta) - logq(theta_p)
