"""The plain reference of the LM chain's checked steps, following the
program's own theta' (a random-walk proposal has no second reading: the
stream it draws is the program's own): the proposal judged by its rule and
by the share of elements it moves up and down against their exact
probabilities, the prior's log ratio in float64, and each section's
log-likelihood under theta and theta' by the float32 forward of :mod:`glm`,
following the decisions it is given from one step to the next. Imports
nothing of the port.

:func:`rw_proposal` is the program's random walk written plainly (log u
first, then each leaf's N(0, 1) noise in sorted path order, by chunks of
rows of at most 2**26 elements, added in float32): the control proposes with
it, and a CPU test holds the program's draws to it. No check of a run
depends on that order.
"""
from __future__ import annotations

import numpy as np
import torch

from mcmcbench.lib import inputs
from mcmcbench.reference import glm

ROW_CHUNK = 1 << 26  # the proposal's chunk of rows: the noise stream's order


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(tree[k], path) if isinstance(tree[k], dict) else {path: tree[k]})
    return out


def row_chunks(t: torch.Tensor) -> list:
    """Views of ``t`` along its leading axis, each of at most ROW_CHUNK
    elements (one chunk at or under the bound, or under two dims)."""
    if t.numel() <= ROW_CHUNK or t.ndim < 2:
        return [t]
    return list(t.split(max(1, ROW_CHUNK // max(1, t[0].numel())), 0))


def draw_log_u(gen, device) -> float:
    u = torch.rand((), generator=gen, dtype=torch.float32, device=device)
    return float(torch.log(torch.clamp_min(u, 1e-20)))


def rw_proposal(gen, params: dict, sigma: float) -> dict:
    """theta' = theta + sigma * N(0, 1), in float32 then the leaf's dtype,
    leaf by leaf in sorted path order, by chunks of rows."""
    out = {}
    for path, leaf in flat(params).items():
        new = torch.empty_like(leaf)
        for src, dst in zip(row_chunks(leaf), row_chunks(new)):
            noise = torch.randn(src.shape, generator=gen, dtype=torch.float32, device=src.device)
            dst.copy_(torch.add(src, noise, alpha=sigma))
        out[path] = new
    return inputs.nest(out)


def sq_total(params: dict) -> float:
    """sum(theta^2) over every leaf, in float64."""
    return float(sum(c.double().square().sum().item()
                     for leaf in flat(params).values() for c in row_chunks(leaf)))


def _spacings(t: torch.Tensor):
    """The gaps from each bfloat16 value of ``t`` to its neighbours above and
    below (float64): 2**(e - 7) for |t| in [2**e, 2**(e + 1)), half that
    on the side towards zero where |t| is a power of two."""
    a = t.double().abs()
    e = torch.floor(torch.log2(a.clamp_min(2.0 ** -126)))
    ulp = torch.exp2(e - 7)
    pow2 = a == torch.exp2(e)
    away, toward = ulp, torch.where(pow2, ulp / 2, ulp)
    pos = t >= 0
    up, down = torch.where(pos, away, toward), torch.where(pos, toward, away)
    tiny = a < 2.0 ** -126  # zero and subnormals: always moved
    return up.masked_fill(tiny, 0.0), down.masked_fill(tiny, 0.0)


def move_z(before: dict, after: dict, sigma: float) -> float:
    """The proposal against its rule, theta' = bf16(theta + sigma N(0, 1)),
    on sampled elements: for each leaf and for all leaves together, the
    count of elements moved up and of those moved down against its
    expectation, in standard deviations (each element moves up with
    probability P(sigma N > half the gap above), down likewise); the largest
    of these |z|. Independent of the order the noise is drawn in."""
    normal = torch.distributions.Normal(torch.tensor(0.0, dtype=torch.float64),
                                        torch.tensor(1.0, dtype=torch.float64))
    worst, tot = 0.0, torch.zeros(2, 2, dtype=torch.float64)  # (up, down) x (obs - E, var)
    for path, t in before.items():
        t = t.to(torch.bfloat16).reshape(-1)
        t_p = after[path].to(torch.bfloat16).reshape(-1)
        up, down = _spacings(t)
        p_up = 1.0 - normal.cdf(up / (2.0 * sigma))
        p_dn = 1.0 - normal.cdf(down / (2.0 * sigma))
        for k, (p, moved) in enumerate(((p_up, t_p > t), (p_dn, t_p < t))):
            diff, var = float(moved.double().sum() - p.sum()), float((p * (1 - p)).sum())
            tot[k] += torch.tensor([diff, var], dtype=torch.float64)
            worst = max(worst, abs(diff) / max(var, 1.0) ** 0.5)
    for diff, var in tot.tolist():
        worst = max(worst, abs(diff) / max(var, 1.0) ** 0.5)
    return worst


class Chain:
    """The reference's steps from a cell's start, following the theta' and
    the decisions it is handed (the control's, with ``weight_cast``)."""

    def __init__(self, cell, device, weight_cast=None):
        self.device = device
        self.sizes = inputs.dense_sizes(cell.config)
        self.tr, self.post = cell.traffic, cell.config["posterior"]
        self.cast = weight_cast
        layout = inputs.dense_layout(self.sizes, cell.config["assumed"]["init_std"])
        self.theta = inputs.draw_params(layout, cell.config["assumed"]["weights_seed"], device)
        self.tokens = inputs.markov_pool(self.tr["pool_seed"], self.tr["pool"], self.tr["seq_len"],
                                         self.sizes["vocab"], self.tr["concentration"],
                                         device)["tokens"]
        self.sq = sq_total(self.theta)
        self.lc = np.zeros(0)  # log-likelihoods under theta of the first sections

    def prior(self, theta_p, total_round=None):
        """sum(theta'^2) and the prior's log ratio of theta' to theta
        (``total_round`` rounds the two totals of squares: the control's)."""
        rnd = total_round or (lambda a: a)
        sq_p = sq_total(theta_p)
        return sq_p, -0.5 / self.post["prior_var"] * float(rnd(sq_p) - rnd(self.sq))

    def logliks(self, theta_p, n_sections: int, first: int = 0):
        """(under theta', under theta) of sections [first, n_sections),
        float64. Those under theta are kept while theta stays (a rejected
        step), so the next step computes only the sections it adds."""
        lp = glm.loglik(theta_p, self.tokens[first:n_sections], self.sizes, weight_cast=self.cast)
        have = len(self.lc)
        if n_sections > have:
            more = glm.loglik(self.theta, self.tokens[have:n_sections], self.sizes,
                              weight_cast=self.cast)
            self.lc = np.concatenate([self.lc, more.double().cpu().numpy()])
        return lp.double().cpu().numpy(), self.lc[first:n_sections]

    def advance(self, accepted: bool, theta_p, sq_p) -> None:
        if accepted:
            self.theta, self.sq, self.lc = theta_p, sq_p, np.zeros(0)
