"""The plain reference of Bayesian logistic regression (the paper's Sec.
4.1): w ~ N(0, prior_var I), y_i in {-1, +1} with p(y_i | x_i, w) =
sigmoid(y_i x_i . w). Log-likelihood deltas and the prior's log ratio in
float64.

``round_operands`` emulates a lower precision for the control: it rounds the
float32 operands of the products to that precision before they are taken.
"""
from __future__ import annotations

import torch

F64 = torch.float64


def log_sigmoid(z: torch.Tensor) -> torch.Tensor:
    return -torch.nn.functional.softplus(-z)


def deltas(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, w_p: torch.Tensor, *,
           round_operands=None, block: int = 256) -> torch.Tensor:
    """l_i(w') - l_i(w) for every row i of x (N, D), for each of the S pairs
    w, w' (S, D): (S, N) float64, in blocks of ``block`` pairs."""
    r = round_operands or (lambda t: t)
    xs = r(x).to(F64)
    ys = y.to(F64)
    out = []
    for a in range(0, w.shape[0], block):
        wa = r(w[a:a + block]).to(F64)
        wb = r(w_p[a:a + block]).to(F64)
        za, zb = wa @ xs.T, wb @ xs.T  # (s, N)
        out.append(log_sigmoid(ys * zb) - log_sigmoid(ys * za))
    return torch.cat(out)


def log_prior_ratio(w: torch.Tensor, w_p: torch.Tensor, prior_var: float) -> torch.Tensor:
    """log N(w'; 0, v I) - log N(w; 0, v I), (S,) float64."""
    a, b = w.to(F64), w_p.to(F64)
    return -0.5 / prior_var * ((b * b).sum(-1) - (a * a).sum(-1))


def replay_draws(gen: torch.Generator, chains: int, d: int, steps: int):
    """The ensemble's draws of its first ``steps`` steps from ``gen``, in its
    order: each step u for all chains, then their (chains, D) N(0, 1) noise.
    Returns log u (steps, chains) and the noise (steps, chains, D)."""
    log_u, xi = [], []
    for _ in range(steps):
        u = torch.rand((chains,), generator=gen, dtype=torch.float32, device=gen.device)
        log_u.append(torch.log(torch.clamp_min(u, 1e-20)))
        xi.append(torch.randn((chains, d), generator=gen, dtype=torch.float32, device=gen.device))
    return torch.stack(log_u), torch.stack(xi)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 explicit mantissa bits), to nearest."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)
