"""Proposal distributions for MH transitions.

The port of ``repro.core.proposals``. A proposal is called as
``proposal(gen, theta[, scale]) -> (theta_prime, log_correction)`` where

    log_correction = log q(theta | theta') - log q(theta' | theta)

and ``gen`` is the ``torch.Generator`` that draws the noise. Theta is a
tensor or a dict / tuple of tensors; with a leading (K,) chain axis the same
call proposes for K chains at once, and ``log_correction`` has shape (K,).
``MALA`` needs the gradient helpers of a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

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
