"""The plain model of the Gibbs sweep kernel's split of the predictive.

``csrc/gibbs_z_sweep.cu`` computes each cluster's collapsed-NIW predictive
as a term of the count alone (a table over 0 .. N), a state of the
statistics and a tail in the point, and computes them at other times than
the plain sweep does. ``kernels.gibbs_z.count_table``, ``cluster_state``
and ``predictive_tail`` are that split in plain PyTorch; composed, they
must give ``niw.predictive_all_clusters`` bit for bit (``torch.equal``):
the split moves operations, it reorders none. Inputs from numpy with a
seed, on the CPU; K_max = 32, the kernel's widest.
"""
import numpy as np
import pytest
import torch

from repro_torch.inference.niw import ClusterStats, NIWPrior, predictive_all_clusters
from repro_torch.kernels.gibbs_z import cluster_state, count_table, predictive_tail

K_MAX, N = 32, 300


def _data(d, seed):
    rng = np.random.default_rng([d, seed])
    centers = rng.normal(0, 2.5, (4, d))
    x = centers[rng.integers(0, 4, N)] + 0.7 * rng.standard_normal((N, d))
    prior = NIWPrior(torch.tensor(rng.normal(0, 0.5, d), dtype=torch.float32), 0.1, 4.0,
                     torch.eye(d) * float(rng.uniform(0.5, 2.0)))
    probes = torch.tensor(centers[rng.integers(0, 4, 40)] + rng.standard_normal((40, d)),
                          dtype=torch.float32)
    return rng, torch.tensor(x, dtype=torch.float32), prior, probes


def _assert_split_equals_niw(x_probe, stats, prior, d):
    table = count_table(prior, d, N)
    got = predictive_tail(x_probe, cluster_state(stats, prior, table))
    want = predictive_all_clusters(x_probe, stats, prior)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("layout", ["random", "lopsided"])
def test_split_predictive_equals_niw(d, layout):
    """Three replicas of K_max = 32 clusters: the points spread over 20
    clusters (12 empty), or lopsided (one cluster holding all N points in
    the first replica, two clusters in the second, a single point alone in
    the third), each probe point against every cluster."""
    rng, x, prior, probes = _data(d, 0 if layout == "random" else 1)
    if layout == "random":
        z = rng.integers(0, 20, (3, N))
    else:
        z = np.zeros((3, N), np.int64)
        z[0] = 7
        z[1] = rng.integers(0, 2, N) * 31
        z[2] = rng.integers(3, 9, N)
        z[2, 17] = 30
    stats = ClusterStats.from_assignments(x, torch.tensor(z), K_MAX)
    _assert_split_equals_niw(probes[:, None, :].expand(40, 3, d), stats, prior, d)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_split_predictive_at_every_count(d):
    """N + 1 replicas, replica n with the first n points in cluster 0 and
    the rest in cluster 1: every count 0 .. N of the table, the empty
    cluster (n = 0) and the full one (n = N), beside 30 empty clusters."""
    rng, x, prior, probes = _data(d, 2)
    z = torch.where(torch.arange(N)[None, :] < torch.arange(N + 1)[:, None], 0, 1)
    stats = ClusterStats.from_assignments(x, z, K_MAX)
    assert torch.equal(stats.n[:, 0], torch.arange(N + 1, dtype=torch.float32))
    _assert_split_equals_niw(probes[:8, None, :].expand(8, N + 1, d), stats, prior, d)
