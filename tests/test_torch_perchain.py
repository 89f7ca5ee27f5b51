"""Per-chain (K, N, D) logit pools in the ``logit`` family
(``repro_torch.core.target_builder``) against the reference's own route:
each chain's rows gathered (``repro.core.target_builder._gather``), then
``repro.kernels.ops.batched_logit_delta``, the Pallas kernel in interpret
mode. Inputs are made with numpy from a seed.

On the CPU the port gathers on the device and takes the plain
``batched_logit_delta_ref``; a pool copied once per chain gives the shared
pool's bits, and a run under a chains x data mesh of four forced CPU slots
is the unsharded run bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.target_builder import _gather as j_gather
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ChainEnsemble, RandomWalk, SubsampledMHConfig, build_target
from repro_torch.distributed import force_devices

torch.set_num_threads(1)
RTOL = 1e-6


def _pools(k, n, d, seed=0):
    rng = np.random.default_rng(seed)
    scales = 1.0 / np.sqrt(1.0 + np.arange(d))
    x = (rng.standard_normal((k, n, d)) * scales).astype(np.float32)
    y = np.where(rng.uniform(size=(k, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    return x, y


def _target(x, y, n):
    return build_target("logit", (torch.tensor(x), torch.tensor(y)), n,
                        prior_logpdf=lambda w: -0.5 * (w ** 2).sum(-1))


def _close(got, want, xg, yg, w, wp):
    """Within 1e-6 of the reference, relative to the two log-sigmoid terms
    the delta subtracts (float64 on the gathered rows): the delta cancels
    them, and the two sides sum a row's D products in other orders (the
    Pallas kernel as a tile product, the plain version row by row)."""
    xg, yg = np.asarray(xg, np.float64), np.asarray(yg, np.float64)
    w, wp = np.asarray(w, np.float64), np.asarray(wp, np.float64)
    if w.ndim == 1:
        w, wp = np.broadcast_to(w, (xg.shape[0], w.size)), np.broadcast_to(wp, (xg.shape[0],
                                                                              wp.size))
    terms = sum(np.abs(np.logaddexp(0.0, -yg * np.einsum("kmd,kd->km", xg, v)))
                for v in (w, wp))
    assert np.all(np.abs(np.asarray(got, np.float64) - want) <= RTOL * terms), \
        float(np.max(np.abs(np.asarray(got, np.float64) - want) / terms))


def _reference_round(x, y, w, wp, idx):
    """The reference's ensemble round on per-chain pools: ``_gather`` of
    each chain's rows, then the Pallas kernel (interpret mode)."""
    xj, yj, ij = jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx)
    return np.asarray(jops.batched_logit_delta(j_gather(xj, ij, 1), j_gather(yj, ij, 0),
                                               jnp.asarray(w), jnp.asarray(wp), mode="always"))


@pytest.mark.parametrize("k,n,d,m", [(1, 40, 3, 7), (3, 200, 5, 16), (4, 1000, 50, 100)])
def test_ensemble_round_matches_reference_route(k, n, d, m):
    """``log_local_ensemble`` and the bound round (``local_round``) on (K, D)
    thetas and (K, m) indices against the reference's route (1e-6 of the
    terms, :func:`_close`); the two port routes equal each other bit for
    bit. The last case is phase A's card case (K = 32 there)."""
    x, y = _pools(k, n, d)
    rng = np.random.default_rng(1)
    w = (0.3 * rng.standard_normal((k, d))).astype(np.float32)
    wp = (w + 0.05 * rng.standard_normal((k, d))).astype(np.float32)
    idx = rng.integers(0, n, (k, m)).astype(np.int32)
    t = _target(x, y, n)
    got = t.log_local_ensemble(torch.tensor(w), torch.tensor(wp), torch.tensor(idx))
    bound = t.local_round(torch.tensor(w), torch.tensor(wp), ensemble=True)(torch.tensor(idx))
    want = _reference_round(x, y, w, wp, idx)
    assert got.shape == (k, m)
    kk = np.arange(k)[:, None]
    _close(got.numpy(), want, x[kk, idx], y[kk, idx], w, wp)
    assert torch.equal(got, bound)


def test_single_chain_forms_match_reference():
    """One theta against per-chain pools, as the reference's single-chain
    ``log_local`` computes it (``logit_delta_ref`` on the gathered (K, m)
    rows), its ``loglik``, and a ``range`` of sections equal to the same
    indices as a tensor."""
    k, n, d = 3, 60, 4
    x, y = _pools(k, n, d, seed=2)
    rng = np.random.default_rng(3)
    w, wp = (0.4 * rng.standard_normal((2, d))).astype(np.float32)
    idx = rng.integers(0, n, (k, 9)).astype(np.int32)
    t = _target(x, y, n)
    jt = J.build_target("logit", (jnp.asarray(x), jnp.asarray(y)), n,
                        prior_logpdf=lambda v: -0.5 * (v ** 2).sum(-1))
    got = t.log_local(torch.tensor(w), torch.tensor(wp), torch.tensor(idx)).numpy()
    want = np.asarray(jt.log_local(jnp.asarray(w), jnp.asarray(wp), jnp.asarray(idx)))
    kk = np.arange(k)[:, None]
    _close(got, want, x[kk, idx], y[kk, idx], w, wp)
    bound = t.local_round(torch.tensor(w), torch.tensor(wp))(torch.tensor(idx)).numpy()
    np.testing.assert_array_equal(bound, got)
    from repro_torch.core.target_builder import get_family

    fam = get_family("logit")
    ll = fam.loglik((torch.tensor(x), torch.tensor(y)), torch.tensor(w), torch.tensor(idx))
    want_ll = np.asarray(jref.logit_loglik(jnp.asarray(w), j_gather(jnp.asarray(x),
                                                                    jnp.asarray(idx), 1),
                                           j_gather(jnp.asarray(y), jnp.asarray(idx), 0)))
    np.testing.assert_allclose(ll.numpy(), want_ll, rtol=RTOL, atol=1e-7)
    run = fam.delta((torch.tensor(x), torch.tensor(y)), torch.tensor(w), torch.tensor(wp),
                    range(5, 17))
    by_idx = fam.delta((torch.tensor(x), torch.tensor(y)), torch.tensor(w), torch.tensor(wp),
                       torch.arange(5, 17).expand(k, -1))
    assert torch.equal(run, by_idx)


def _run(target, k, d, steps, **kw):
    cfg = SubsampledMHConfig(batch_size=40, epsilon=0.05)
    ens = ChainEnsemble(target, RandomWalk(0.05), k, config=cfg, device="cpu", **kw)
    return ens.run(1, ens.init(torch.zeros(d)), steps)


def _same_run(a, b) -> bool:
    (_, sa, ia), (_, sb, ib) = a, b
    return torch.equal(sa, sb) and all(torch.equal(x, y) for x, y in zip(ia, ib))


def test_copied_pool_equals_shared_pool():
    """A shared (N, D) pool copied once per chain into (K, N, D): every
    sample and info field of a K=4 run equal the shared pool's bit for bit
    (the same rows, the same row sums)."""
    k, n, d = 4, 300, 5
    x, y = _pools(1, n, d, seed=4)
    shared = _target(x[0], y[0], n)
    copied = _target(np.repeat(x, k, 0), np.repeat(y, k, 0), n)
    want = _run(shared, k, d, 25)
    assert _same_run(_run(copied, k, d, 25), want)
    assert 0 < float(want[2].accepted.float().mean()) < 1


@pytest.mark.parametrize("shard,stepping", [(("chains", "data"), "lockstep"),
                                             ({"chains": 1, "data": 4}, "lockstep"),
                                             (True, "lockstep"),
                                             (("chains", "data"), "masked")])
def test_sharded_ensemble_equals_unsharded(shard, stepping):
    """Per-chain pools under a mesh of four CPU slots: each slot scores its
    chains' rows of the pool (``chain_rows``), as the reference's
    ``_gather_sharded``; samples and every info field equal the unsharded
    run bit for bit."""
    k, n, d = 4, 300, 5
    x, y = _pools(k, n, d, seed=6)
    t = _target(x, y, n)
    want = _run(t, k, d, 20, stepping=stepping)
    with force_devices(4):
        got = _run(t, k, d, 20, stepping=stepping, shard=shard)
    assert _same_run(got, want)
