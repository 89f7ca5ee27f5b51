"""Collapsed Normal-inverse-Wishart component model: the port of
``repro.inference.niw``.

The joint DP mixture collapses each Gaussian component's (mu_k, Sigma_k)
under a conjugate NIW prior, so a cluster-membership move only needs the
posterior predictive density, a multivariate Student-t, computed from
sufficient statistics that a point's move updates in O(1) (paper Sec. 4.2).

Shapes carry optional leading batch axes: ``ClusterStats`` holds (..., K)
counts, (..., K, D) sums and (..., K, D, D) scatter sums, so one set of
statistics serves one replica or K replicas (a leading (K,) axis). The
log-gamma terms use :func:`repro_torch.kernels.ref.lgamma_fp32`, XLA's
Lanczos form: at df near 1e4, ``torch.lgamma`` and XLA's differ by about
1e-2 in a cluster's log density.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..kernels.ref import lgamma_fp32

_LOG_PI = 1.1447298858494002
F32 = torch.float32


class NIWPrior(NamedTuple):
    m0: torch.Tensor  # (D,)
    k0: float
    v0: float
    s0: torch.Tensor  # (D, D) prior scatter


def _one_hot(k, n_clusters: int, like: torch.Tensor) -> torch.Tensor:
    k = torch.as_tensor(k, device=like.device).long()
    return torch.nn.functional.one_hot(k, n_clusters).to(like.dtype)


class ClusterStats(NamedTuple):
    """Sufficient statistics per cluster, shape-stable for K_max clusters."""

    n: torch.Tensor  # (..., K)
    sum_x: torch.Tensor  # (..., K, D)
    sum_xxt: torch.Tensor  # (..., K, D, D)

    @staticmethod
    def empty(k_max: int, d: int, batch: tuple = (), *, device=None) -> "ClusterStats":
        dev = resolve_device(device)
        return ClusterStats(
            torch.zeros(batch + (k_max,), dtype=F32, device=dev),
            torch.zeros(batch + (k_max, d), dtype=F32, device=dev),
            torch.zeros(batch + (k_max, d, d), dtype=F32, device=dev),
        )

    @staticmethod
    def from_assignments(x: torch.Tensor, z: torch.Tensor, k_max: int) -> "ClusterStats":
        """The statistics of assignments z (..., N) over points x (N, D),
        summed in float64 and rounded once to float32: the same on every run
        (no atomics), and within float32 rounding of any order of adds."""
        onehot = torch.nn.functional.one_hot(z.long(), k_max).to(torch.float64)  # (..., N, K)
        x64 = x.to(torch.float64)
        xx = (x64[:, :, None] * x64[:, None, :]).reshape(x.shape[0], -1)
        ct = onehot.transpose(-1, -2)
        d = x.shape[1]
        return ClusterStats(
            onehot.sum(-2).to(F32),
            (ct @ x64).to(F32),
            (ct @ xx).reshape(ct.shape[:-1] + (d, d)).to(F32),
        )

    def _moved(self, k, x, sign: float) -> "ClusterStats":
        """Add (sign 1) or remove (sign -1) point x (..., D) at cluster k
        (...,): one cluster per batch row; the others add an exact zero."""
        oh = _one_hot(k, self.n.shape[-1], self.n)
        x = x.to(F32)
        return ClusterStats(
            self.n + sign * oh,
            self.sum_x + sign * oh[..., None] * x[..., None, :],
            self.sum_xxt
            + sign * oh[..., None, None] * (x[..., :, None] * x[..., None, :])[..., None, :, :],
        )

    def add(self, k, x) -> "ClusterStats":
        return self._moved(k, x, 1.0)

    def remove(self, k, x) -> "ClusterStats":
        return self._moved(k, x, -1.0)


def _mvt_logpdf(x: torch.Tensor, df: torch.Tensor, loc: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Multivariate Student-t log density; scale is the (..., D, D) shape
    matrix, x and loc (..., D) broadcast against it, df (...)."""
    d = x.shape[-1]
    chol = torch.linalg.cholesky_ex(scale)[0]  # no host sync for the error flag
    diff = torch.linalg.solve_triangular(chol, (x - loc)[..., None], upper=False)[..., 0]
    quad = (diff * diff).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return (
        lgamma_fp32((df + d) / 2.0)
        - lgamma_fp32(df / 2.0)
        - 0.5 * d * (torch.log(df) + _LOG_PI)
        - 0.5 * logdet
        - 0.5 * (df + d) * torch.log1p(quad / df)
    )


def posterior_predictive_logpdf(x: torch.Tensor, stats_n: torch.Tensor, stats_sum: torch.Tensor,
                                stats_xxt: torch.Tensor, prior: NIWPrior) -> torch.Tensor:
    """log p(x | cluster stats) under the collapsed NIW model, broadcast
    over leading axes: x (..., D), stats_n (...), stats_sum (..., D),
    stats_xxt (..., D, D).

    Standard conjugate updates (Murphy 2007):
      kn = k0 + n, vn = v0 + n, mn = (k0 m0 + sum_x) / kn
      Sn = S0 + sum_xxt + k0 m0 m0' - kn mn mn'
      x | stats ~ t_{vn - D + 1}(mn, Sn (kn+1) / (kn (vn - D + 1)))
    """
    df, mn, scale = _predictive_t(stats_n, stats_sum, stats_xxt, prior, x.shape[-1])
    return _mvt_logpdf(x, df, mn, scale)


def _predictive_t(stats_n, stats_sum, stats_xxt, prior: NIWPrior, d: int):
    """(df, loc, shape matrix) of the predictive Student-t of each cluster."""
    m0, s0 = prior.m0.to(F32), prior.s0.to(F32)
    kn = prior.k0 + stats_n
    vn = prior.v0 + stats_n
    mn = (prior.k0 * m0 + stats_sum) / kn[..., None]
    sn = (s0 + stats_xxt + prior.k0 * torch.outer(m0, m0)
          - kn[..., None, None] * (mn[..., :, None] * mn[..., None, :]))
    df = vn - d + 1.0
    scale = sn * (kn + 1.0)[..., None, None] / (kn * df)[..., None, None]
    # guard: keep scale SPD even for nearly-empty clusters
    scale = scale + 1e-6 * torch.eye(d, dtype=F32, device=scale.device)
    return df, mn, scale


def predictive_all_clusters(x: torch.Tensor, stats: ClusterStats, prior: NIWPrior) -> torch.Tensor:
    """The posterior predictive of x under every cluster: x (..., D) against
    stats over (..., K_max) -> (..., K_max), the Cholesky factors batched
    over the clusters."""
    return posterior_predictive_logpdf(x[..., None, :], stats.n, stats.sum_x, stats.sum_xxt, prior)


def predictive_rows(x: torch.Tensor, stats: ClusterStats, prior: NIWPrior) -> torch.Tensor:
    """The density of :func:`predictive_all_clusters` for every row of x
    (B, D) under statistics over (..., K_max) -> (..., B, K_max), with one
    Cholesky factor per cluster solved against all B rows as right-hand
    sides (where broadcasting x against the clusters would factor and solve
    once per row). Each row's value depends on that row alone."""
    d = x.shape[-1]
    df, mn, scale = _predictive_t(stats.n, stats.sum_x, stats.sum_xxt, prior, d)
    chol = torch.linalg.cholesky_ex(scale)[0]  # (..., K, D, D)
    rhs = x.T.to(F32) - mn[..., :, None]  # (..., K, D, B)
    sol = torch.linalg.solve_triangular(chol, rhs, upper=False)
    quad = (sol * sol).sum(-2)  # (..., K, B)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    norm = (lgamma_fp32((df + d) / 2.0) - lgamma_fp32(df / 2.0)
            - 0.5 * d * (torch.log(df) + _LOG_PI) - 0.5 * logdet)
    out = norm[..., None] - 0.5 * (df + d)[..., None] * torch.log1p(quad / df[..., None])
    return out.transpose(-1, -2)
