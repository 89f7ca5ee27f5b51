"""Draw combination: subposterior windows -> one full-posterior window, the
port of ``repro.partition.combine`` (host float64 numpy, as there).

Two rules over the P per-partition windows (each a tree of (K, W, ...)
draws):

  * **consensus** (Scott et al.): weighted averaging of aligned draws,
    ``theta_s = (sum_p W_p)^-1 sum_p W_p theta_{p,s}`` with ``W_p`` the
    inverse subposterior sample covariance; exact for Gaussian
    subposteriors;
  * **product** (Gaussian density product): fit ``N(mu_p, Sigma_p)`` to each
    subposterior, form ``Sigma = (sum_p Sigma_p^-1)^-1``, ``mu = Sigma sum_p
    Sigma_p^-1 mu_p``, and draw a fresh window from it with a seeded
    generator (deterministic per version).

The arithmetic is the reference's, in its order of reduction, so the same
draws give the same values. Trees are flattened in the reference's leaf
order (dict keys sorted), and combined windows keep the (K, W, ...) shape
and leaf dtypes the :class:`~repro_torch.serving.resident.SnapshotEvaluator`
consumes: the router serves combined draws through the same evaluator as
every other window.
"""
from __future__ import annotations

import time
import zlib
from typing import Any, Sequence

import numpy as np

from ..serving.resident import Snapshot

METHODS = ("consensus", "product")


# ---------------------------------------------------------------------------
# Trees in the reference's leaf order
# ---------------------------------------------------------------------------


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def _rebuild(template: Any, leaves) -> Any:
    """``template``'s nesting with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, leaves) for v in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _map(fn, tree: Any) -> Any:
    return _rebuild(tree, iter([fn(l) for l in _leaves(tree)]))


# ---------------------------------------------------------------------------
# Flatten / unflatten
# ---------------------------------------------------------------------------


def flatten_draws(draws: Any) -> np.ndarray:
    """(K, W, ...) tree -> (S, D) float64 matrix, S = K*W, leaves
    concatenated along the feature axis in tree order."""
    leaves = _leaves(draws)
    if not leaves:
        raise ValueError("empty draws tree")
    flats = []
    for leaf in leaves:
        a = np.asarray(leaf, np.float64)
        flats.append(a.reshape(a.shape[0] * a.shape[1], -1))
    return np.concatenate(flats, axis=1)


def unflatten_draws(flat: np.ndarray, template: Any) -> Any:
    """Inverse of :func:`flatten_draws`: a (S, D) matrix back onto
    ``template``'s tree and (K, W, ...) leaf shapes, cast to each leaf's
    dtype."""
    leaves = [np.asarray(l) for l in _leaves(template)]
    k, w = leaves[0].shape[:2]
    if flat.shape[0] != k * w:
        raise ValueError(f"flat draws rows {flat.shape[0]} != template K*W {k * w}")
    out, col = [], 0
    for leaf in leaves:
        width = int(np.prod(leaf.shape[2:], dtype=np.int64)) if leaf.ndim > 2 else 1
        block = flat[:, col:col + width]
        col += width
        out.append(block.reshape((k, w) + tuple(leaf.shape[2:])).astype(leaf.dtype))
    if col != flat.shape[1]:
        raise ValueError(f"flat draws have {flat.shape[1]} columns, used {col}")
    return _rebuild(template, iter(out))


def trim_windows(draws_list: Sequence[Any]) -> list[Any]:
    """Equal window depth across partitions: each window's trailing
    (freshest) ``W_min`` draws per chain. Chain counts must agree."""
    ks = {np.shape(_leaves(d)[0])[0] for d in draws_list}
    if len(ks) != 1:
        raise ValueError(f"partitions disagree on chain count: {sorted(ks)}")
    w_min = min(np.shape(_leaves(d)[0])[1] for d in draws_list)
    return [_map(lambda a: a[:, -w_min:], d) for d in draws_list]


# ---------------------------------------------------------------------------
# Moments and combination rules (float64, the reference's reduction order)
# ---------------------------------------------------------------------------


def _moments(flat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mean = flat.mean(axis=0)
    centered = flat - mean
    cov = (centered.T @ centered) / max(flat.shape[0] - 1, 1)
    return mean, np.atleast_2d(cov)


def _weight(cov: np.ndarray, ridge: float) -> np.ndarray:
    d = cov.shape[0]
    lam = ridge * max(np.trace(cov) / d, 1e-300)
    return np.linalg.inv(cov + lam * np.eye(d))


def consensus_combine(flats: Sequence[np.ndarray], ridge: float = 1e-9) -> np.ndarray:
    """``(sum W_p)^-1 sum W_p theta_{p,s}`` over aligned (S, D) draws, with
    ``W_p`` the (ridge-regularised) inverse subposterior covariance."""
    if len({f.shape for f in flats}) != 1:
        raise ValueError(f"consensus needs aligned draw matrices, got {[f.shape for f in flats]}")
    weights = [_weight(_moments(f)[1], ridge) for f in flats]
    w_sum = np.sum(weights, axis=0)
    weighted = np.sum([w @ f.T for w, f in zip(weights, flats)], axis=0)
    return np.linalg.solve(w_sum, weighted).T


def product_moments(flats: Sequence[np.ndarray],
                    ridge: float = 1e-9) -> tuple[np.ndarray, np.ndarray]:
    """The density product's mean and covariance from per-partition
    moments."""
    precisions, weighted_means = [], []
    for f in flats:
        mean, cov = _moments(f)
        w = _weight(cov, ridge)
        precisions.append(w)
        weighted_means.append(w @ mean)
    precision = np.sum(precisions, axis=0)
    cov = np.linalg.inv(precision)
    mean = cov @ np.sum(weighted_means, axis=0)
    return mean, cov


def product_combine(flats: Sequence[np.ndarray], num_samples: int, seed: int = 0,
                    ridge: float = 1e-9) -> np.ndarray:
    """``num_samples`` iid draws from the density-product Gaussian, from
    ``np.random.default_rng(seed)``."""
    mean, cov = product_moments(flats, ridge)
    chol = np.linalg.cholesky(cov + 1e-300 * np.eye(cov.shape[0]))
    z = np.random.default_rng(int(seed) & 0xFFFFFFFF).standard_normal(
        (num_samples, mean.shape[0]))
    return mean[None, :] + z @ chol.T


# ---------------------------------------------------------------------------
# Window-level entry points (what the fleet router calls)
# ---------------------------------------------------------------------------


def combine_draws(draws_list: Sequence[Any], method: str = "consensus", *, seed: int = 0,
                  ridge: float = 1e-9) -> Any:
    """P per-partition windows -> one full-posterior window, the same tree
    and (K, W_min, ...) leaf shapes; one window is returned as is."""
    if method not in METHODS:
        raise ValueError(f"unknown combine method {method!r}; known: {METHODS}")
    draws_list = list(draws_list)
    if not draws_list:
        raise ValueError("no partition windows to combine")
    if len(draws_list) == 1:
        return draws_list[0]
    trimmed = trim_windows(draws_list)
    flats = [flatten_draws(d) for d in trimmed]
    if method == "consensus":
        combined = consensus_combine(flats, ridge)
    else:
        combined = product_combine(flats, flats[0].shape[0], seed, ridge)
    return unflatten_draws(combined, trimmed[0])


def combine_snapshots(snaps: Sequence[Snapshot], method: str = "consensus", *,
                      ridge: float = 1e-9) -> Snapshot:
    """One servable :class:`Snapshot` from P per-partition snapshots.

    ``steps_done`` is the sum of the partitions' versions (it grows whenever
    one advances: the combined generation key) and ``staleness_s`` the
    largest of theirs; the product rule's seed is the ``crc32`` of the
    version tuple, so a combined generation is deterministic.
    """
    snaps = list(snaps)
    if any(s.draws is None for s in snaps):
        missing = [i for i, s in enumerate(snaps) if s.draws is None]
        raise RuntimeError(f"partition(s) {missing} have no window yet")
    seed = zlib.crc32(np.asarray([s.steps_done for s in snaps], np.int64).tobytes())
    combined = combine_draws([s.draws for s in snaps], method, seed=seed, ridge=ridge)
    lead = np.shape(_leaves(combined)[0])
    return Snapshot(
        draws=combined,
        num_draws=int(lead[0] * lead[1]),
        steps_done=int(sum(s.steps_done for s in snaps)),
        staleness_s=max(s.staleness_s for s in snaps),
        summary={"combine": {"method": method, "partitions": len(snaps)}},
        created_at=time.monotonic(),
    )
