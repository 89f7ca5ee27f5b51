"""Primitive distributions for the PET layer (log-pdfs + forward samplers).

The port of ``repro.ppl.dists``. Shapes broadcast; ``logpdf`` returns
elementwise log densities (callers sum) in float32, with numbers among the
parameters taken as float32 tensors on the value's device. ``sample(gen,
*params, shape=())`` draws from a ``torch.Generator`` on its device, where
the reference takes a key. The three log-gamma users (``Gamma``,
``InvGamma``, ``Beta``) call :func:`repro_torch.kernels.ref.lgamma_fp32`,
XLA's Lanczos lgamma in XLA's operation order, so that their densities
follow the reference as the rest of the port does.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.ref import lgamma_fp32

_LOG2PI = 1.8378770664093453


def _tensors(*args, device=None):
    """Every argument as a float32 tensor on ``device``, by default the
    device of the first tensor among them."""
    dev = device or next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in args]


def _shape(shape, *params) -> tuple:
    """The draw's shape: ``shape`` broadcast with the parameters' shapes."""
    return torch.broadcast_shapes(tuple(shape), *(p.shape for p in params))


def _std_gamma(gen, a, shape):
    return torch._standard_gamma(torch.broadcast_to(a, _shape(shape, a)), generator=gen)


@dataclasses.dataclass(frozen=True)
class Distribution:
    def logpdf(self, x, *params):  # pragma: no cover - interface
        raise NotImplementedError

    def sample(self, gen, *params, shape=()):  # pragma: no cover - interface
        raise NotImplementedError


class Normal(Distribution):
    def logpdf(self, x, loc, scale):
        x, loc, scale = _tensors(x, loc, scale)
        z = (x - loc) / scale
        return -0.5 * (z * z + _LOG2PI) - torch.log(scale)

    def sample(self, gen, loc, scale, shape=()):
        loc, scale = _tensors(loc, scale, device=gen.device)
        return loc + scale * torch.randn(shape, generator=gen, device=gen.device)


class Bernoulli(Distribution):
    """Support {0., 1.}; parameterized by probability p."""

    def logpdf(self, x, p):
        x, p = _tensors(x, p)
        p = torch.clamp(p, 1e-7, 1 - 1e-7)
        return x * torch.log(p) + (1 - x) * torch.log1p(-p)

    def sample(self, gen, p, shape=()):
        (p,) = _tensors(p, device=gen.device)
        u = torch.rand(_shape(shape, p), generator=gen, device=gen.device)
        return (u < p).to(torch.float32)


class BernoulliLogits(Distribution):
    """Support {-1., +1.} with logits z: log p(y|z) = -log(1 + exp(-y z)).

    This is the Logit(y|x, w) factor of the paper's regression models.
    """

    def logpdf(self, y, z):
        y, z = _tensors(y, z)
        t = -y * z
        return -torch.logaddexp(torch.zeros_like(t), t)

    def sample(self, gen, z, shape=()):
        (z,) = _tensors(z, device=gen.device)
        u = torch.rand(_shape(shape, z), generator=gen, device=gen.device)
        return torch.where(u < torch.sigmoid(z), 1.0, -1.0)


class Gamma(Distribution):
    def logpdf(self, x, a, rate):
        x, a, rate = _tensors(x, a, rate)
        return a * torch.log(rate) - lgamma_fp32(a) + (a - 1) * torch.log(x) - rate * x

    def sample(self, gen, a, rate, shape=()):
        a, rate = _tensors(a, rate, device=gen.device)
        return _std_gamma(gen, a, shape) / rate


class InvGamma(Distribution):
    def logpdf(self, x, a, scale):
        x, a, scale = _tensors(x, a, scale)
        return a * torch.log(scale) - lgamma_fp32(a) - (a + 1) * torch.log(x) - scale / x

    def sample(self, gen, a, scale, shape=()):
        a, scale = _tensors(a, scale, device=gen.device)
        return scale / _std_gamma(gen, a, shape)


class Beta(Distribution):
    def logpdf(self, x, a, b):
        x, a, b = _tensors(x, a, b)
        lbeta = lgamma_fp32(a) + lgamma_fp32(b) - lgamma_fp32(a + b)
        return (a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x) - lbeta

    def sample(self, gen, a, b, shape=()):
        a, b = _tensors(a, b, device=gen.device)
        shape = _shape(shape, a, b)
        ga, gb = _std_gamma(gen, a, shape), _std_gamma(gen, b, shape)
        return ga / (ga + gb)


class MVNormalDiag(Distribution):
    def logpdf(self, x, loc, scale):
        x, loc, scale = _tensors(x, loc, scale)
        z = (x - loc) / scale
        return torch.sum(-0.5 * (z * z + _LOG2PI) - torch.log(scale), dim=-1)

    def sample(self, gen, loc, scale, shape=()):
        loc, scale = _tensors(loc, scale, device=gen.device)
        noise = torch.randn(tuple(shape) + tuple(loc.shape), generator=gen, device=gen.device)
        return loc + scale * noise


class Uniform(Distribution):
    def logpdf(self, x, lo, hi):
        x, lo, hi = _tensors(x, lo, hi)
        inside = (x >= lo) & (x <= hi)
        return torch.where(inside, -torch.log(hi - lo), -torch.inf)

    def sample(self, gen, lo, hi, shape=()):
        lo, hi = _tensors(lo, hi, device=gen.device)
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


normal = Normal()
bernoulli = Bernoulli()
bernoulli_logits = BernoulliLogits()
gamma = Gamma()
inv_gamma = InvGamma()
beta = Beta()
mvnormal_diag = MVNormalDiag()
uniform = Uniform()
