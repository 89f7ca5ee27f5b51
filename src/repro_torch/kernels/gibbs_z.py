"""The collapsed Gibbs sweep over a joint DP mixture's assignments, as one
kernel for K replicas.

The port of the ``fori_loop`` in ``repro.experiments.jointdpm.gibbs_z_steps``
(Neal's Algorithm 8 with one auxiliary component): for P points in order,
remove the point from its cluster's NIW statistics, score every one of the
K_max clusters (collapsed-NIW Student-t predictive, CRP term, logistic label
term under w, the auxiliary slot under a fresh prior draw), pick one, and add
the point back. The steps depend on each other, so the whole sweep is one
launch (``csrc/gibbs_z_sweep.cu``), one block a replica.

The kernel splits each cluster's predictive into a term of its count alone
(a table over 0 .. N), a state of its statistics (mean, Cholesky factor,
log det, df) and a tail in the point, and computes the state for the next
step's possible outcomes while the current step picks. :func:`count_table`,
:func:`cluster_state` and :func:`predictive_tail` are that split in plain
PyTorch; composed they give the bits of
:func:`repro_torch.inference.niw.predictive_all_clusters`, which the tests
check (the split reorders no operation).

The wrapper takes the random numbers from the caller (:func:`draw_sweep_
randomness`: the auxiliary expert's D + 1 standard normals and one uniform a
step), so the kernel and the plain version :func:`gibbs_z_sweep_ref` are
comparable value for value. The pick is an inverse CDF from one uniform, in
the warp's order of additions (:func:`repro_torch.kernels.ref.lane_order_cdf`):
the first cluster of positive probability whose CDF exceeds the uniform, or
else the last one of positive probability. It draws from the categorical
distribution the reference's Gumbel-max ``jax.random.categorical`` draws
from. z, w and the statistics are updated in place:

  x (N, D) f32   y (N,) f32   z (K, N) int32   w (K, K_max, D+1) f32
  log_alpha (K,) f32   stats: n (K, K_max), sum_x (K, K_max, D),
  sum_xxt (K, K_max, D, D) f32   points (K, P) int32
  nrm (K, P, D+1) f32   u (K, P) f32   prior: NIWPrior   w_sd: float

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build
from .ref import _softplus, lane_order_cdf, lgamma_fp32

NAME = "gibbs_z_sweep"
MAX_CLUSTERS = 32  # one lane a cluster
MAX_D = 4  # the kernel's instantiations
MAX_POINTS = 227 * 1024  # the interface's limit on N

__all__ = ["gibbs_z_sweep", "gibbs_z_sweep_ref", "draw_sweep_randomness", "first_divergence",
           "sums_drift", "count_table", "cluster_state", "predictive_tail"]

_LOG_PI = 1.1447298858494002


def count_table(prior, d: int, n_max: int) -> torch.Tensor:
    """The predictive's terms that depend on the count n alone, for n = 0 ..
    n_max (n_max + 1,): lgamma((df + D) / 2) - lgamma(df / 2) - D/2 (log df
    + log pi), df = v0 + n - D + 1, in the predictive's operation order."""
    n = torch.arange(n_max + 1, dtype=torch.float32, device=prior.m0.device)
    df = prior.v0 + n - d + 1.0
    return lgamma_fp32((df + d) / 2.0) - lgamma_fp32(df / 2.0) - 0.5 * d * (torch.log(df) + _LOG_PI)


def cluster_state(stats, prior, table: torch.Tensor):
    """Each cluster's predictive state from its statistics (leading axes as
    ``stats``): the mean mn (..., K, D), the lower Cholesky factor of the
    scale (..., K, D, D), ``a`` = the count's table entry - log det / 2,
    ``c`` = (df + D) / 2 and df (..., K). The counts must be integers
    within the table."""
    f32 = torch.float32
    d = stats.sum_x.shape[-1]
    m0, s0 = prior.m0.to(f32), prior.s0.to(f32)
    kn = prior.k0 + stats.n
    vn = prior.v0 + stats.n
    mn = (prior.k0 * m0 + stats.sum_x) / kn[..., None]
    sn = (s0 + stats.sum_xxt + prior.k0 * torch.outer(m0, m0)
          - kn[..., None, None] * (mn[..., :, None] * mn[..., None, :]))
    df = vn - d + 1.0
    scale = sn * (kn + 1.0)[..., None, None] / (kn * df)[..., None, None]
    scale = scale + 1e-6 * torch.eye(d, dtype=f32, device=scale.device)
    chol = torch.linalg.cholesky_ex(scale)[0]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return mn, chol, table[stats.n.long()] - 0.5 * logdet, 0.5 * (df + d), df


def predictive_tail(x: torch.Tensor, state) -> torch.Tensor:
    """The predictive of x (..., D) under every cluster of ``state``
    (:func:`cluster_state`) -> (..., K): the part that depends on x."""
    mn, chol, a, c, df = state
    diff = torch.linalg.solve_triangular(chol, (x[..., None, :] - mn)[..., None],
                                         upper=False)[..., 0]
    quad = (diff * diff).sum(-1)
    return a - c * torch.log1p(quad / df)


def draw_sweep_randomness(gen: torch.Generator, k: int, p: int, d: int, device):
    """The sweep's random numbers, in the order the generator gives them:
    nrm (K, P, D+1) standard normal, then u (K, P) uniform on [0, 1)."""
    nrm = torch.randn((k, p, d + 1), generator=gen, device=device)
    u = torch.rand((k, p), generator=gen, device=device)
    return nrm, u


def gibbs_z_sweep_ref(x, y, z, w, log_alpha, stats, points, nrm, u, prior, w_sd: float,
                      record: bool = False):
    """Plain version of :func:`gibbs_z_sweep` (same in-place contract): a
    loop over the P steps of (K, K_max) tensor operations, in the kernel's
    order (remove, the per-cluster terms, the max-subtracted softmax, the
    inclusive scan, the pick, the add). With ``record`` it returns each
    step's CDF and positive-probability mask, (K, P, K_max) each, for
    locating a borderline pick; otherwise None."""
    from ..inference.niw import ClusterStats, predictive_all_clusters

    k, n_points = points.shape
    k_max = w.shape[1]
    rows = torch.arange(k, device=z.device)
    slots = torch.arange(k_max, device=z.device)
    st = ClusterStats(stats.n.clone(), stats.sum_x.clone(), stats.sum_xxt.clone())
    w_now = w.clone()
    neg_inf = torch.tensor(-math.inf, device=z.device)
    cdfs, masses = [], []
    for t in range(n_points):
        i = points[:, t].long()
        xi, yi = x[i], y[i]
        st = st.remove(z[rows, i], xi)
        counts = st.n
        aux = (counts < 0.5).to(torch.int32).argmax(-1)  # slot 0 when none is empty
        w_eff = w_now.clone()
        w_eff[rows, aux] = w_sd * nrm[:, t]
        feat = predictive_all_clusters(xi, st, prior)
        x_aug = torch.cat([xi, torch.ones_like(xi[:, :1])], -1)
        lab = -_softplus(-yi[:, None] * (w_eff @ x_aug[:, :, None])[..., 0])
        crp = torch.where(counts > 0.5, torch.log(torch.clamp_min(counts, 1e-12)),
                          torch.where(slots == aux[:, None], log_alpha[:, None], neg_inf))
        logp = crp + feat + lab
        cdf = lane_order_cdf(logp)
        mass = torch.exp(logp - logp.amax(-1, keepdim=True)) > 0
        hit = mass & (cdf > u[:, t, None])
        last = k_max - 1 - mass.flip(-1).to(torch.int32).argmax(-1)
        k_new = torch.where(hit.any(-1), hit.to(torch.int32).argmax(-1), last)
        z[rows, i] = k_new.to(z.dtype)
        w_now = torch.where((k_new == aux)[:, None, None], w_eff, w_now)
        st = st.add(k_new, xi)
        if record:
            cdfs.append(cdf)
            masses.append(mass)
    w.copy_(w_now)
    stats.n.copy_(st.n)
    stats.sum_x.copy_(st.sum_x)
    stats.sum_xxt.copy_(st.sum_xxt)
    if record:
        return torch.stack(cdfs, 1), torch.stack(masses, 1)
    return None


def first_divergence(points, u, z_a, z_b, cdf, mass, tol: float = 1e-5) -> list:
    """Where two sweeps from the same state and numbers first pick apart:
    for each replica whose final z differ, ``(replica, step, borderline)``,
    ``borderline`` meaning that the step's uniform lies within ``tol`` of a
    boundary of the CDF that ``cdf``/``mass`` (the plain version's record)
    give for that step. The points of a sweep are distinct, so the picks
    are the final z of the points in step order."""
    out = []
    pick_a = z_a.gather(1, points.long())
    pick_b = z_b.gather(1, points.long())
    for r in torch.nonzero((pick_a != pick_b).any(-1)).flatten().tolist():
        t = int(torch.nonzero(pick_a[r] != pick_b[r])[0])
        bounds = cdf[r, t][mass[r, t]]
        gap = float((bounds - u[r, t]).abs().min())
        out.append((r, t, gap <= tol))
    return out


def sums_drift(stats, exact) -> float:
    """How far a sweep's running float32 sums (``stats``) lie from ``exact``
    (:meth:`repro_torch.inference.niw.ClusterStats.from_assignments` of its
    z): the largest difference of ``sum_x`` and of ``sum_xxt``, each over
    its largest magnitude. Each add and remove rounds to the running sum's
    ulp, so over P steps the sums drift by a few ulps of their size (~1e-6
    of it), not by a fixed amount."""
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1.0))
               for a, b in zip(stats[1:], exact[1:]))


@functools.cache
def _bind():
    fn = _build.load("gibbs_z_sweep").gibbs_z_sweep
    P, I, FL = _build.P, _build.I, _build.FL
    fn.argtypes = [P, P, P, I, I, P, P, P, P, P, P, I, I, P, P, I, P, FL, FL, FL, P]
    fn.restype = I
    return fn


def gibbs_z_sweep(x, y, z, w, log_alpha, stats, points, nrm, u, prior, w_sd: float) -> None:
    """One sweep of every replica from given random numbers, in place on z,
    w and the statistics. Launches the kernel on CUDA tensors (the plain
    version on CPU tensors)."""
    if z.device.type == "cpu":
        gibbs_z_sweep_ref(x, y, z, w, log_alpha, stats, points, nrm, u, prior, w_sd)
        return
    if z.device.type != "cuda":
        raise ValueError(f"gibbs_z_sweep has no kernel for device {z.device}")
    if z.ndim != 2 or w.ndim != 3:
        raise ValueError(f"z must be (K, N) and w (K, K_max, D+1), got {tuple(z.shape)}, "
                         f"{tuple(w.shape)}")
    k, n = z.shape
    k_max, d = w.shape[1], w.shape[2] - 1
    p = points.shape[-1]
    if k_max > MAX_CLUSTERS:
        raise ValueError(f"the sweep kernel puts a cluster on each lane: K_max <= "
                         f"{MAX_CLUSTERS}, got {k_max}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the sweep kernel takes 1 <= D <= {MAX_D}, got {d}")
    if n > MAX_POINTS:
        raise ValueError(f"the sweep kernel takes N <= {MAX_POINTS}, got {n}")
    dev, f32 = z.device, (torch.float32,)
    _build.require(x, "x", dev, f32, (n, d))
    _build.require(y, "y", dev, f32, (n,))
    _build.require(z, "z", dev, (torch.int32,), (k, n))
    _build.require(w, "w", dev, f32, (k, k_max, d + 1))
    _build.require(log_alpha, "log_alpha", dev, f32, (k,))
    _build.require(stats.n, "n", dev, f32, (k, k_max))
    _build.require(stats.sum_x, "sum_x", dev, f32, (k, k_max, d))
    _build.require(stats.sum_xxt, "sum_xxt", dev, f32, (k, k_max, d, d))
    _build.require(points, "points", dev, (torch.int32,), (k, p))
    _build.require(nrm, "nrm", dev, f32, (k, p, d + 1))
    _build.require(u, "u", dev, f32, (k, p))
    packed = torch.cat([prior.m0.to(dev, torch.float32).reshape(-1),
                        prior.s0.to(dev, torch.float32).reshape(-1)])
    q = _build.ptr
    err = _build.launch(_bind(), z.device,
        q(x), q(y), q(z), n, d, q(w), q(log_alpha), q(stats.n), q(stats.sum_x), q(stats.sum_xxt),
        q(points), k, p, q(nrm), q(u), k_max, q(packed), float(prior.k0), float(prior.v0),
        float(w_sd), _build.stream_of(z))
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
