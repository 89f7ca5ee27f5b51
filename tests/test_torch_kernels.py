"""The port's kernel modules against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and handed to both packages. The JAX
kernels run in interpret mode on the CPU, as ``tests/test_kernels.py`` runs
them; the port's wrappers take their plain PyTorch versions because the
tensors lie on the CPU. The CUDA kernels themselves are held against the
plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stats as jstats
from repro.core.sequential_test import test_round_decision as j_round_decision
from repro.kernels import ops as jops
from repro.kernels.batched_loglik import batched_logit_delta as j_batched
from repro.kernels.batched_loglik import gather_and_delta as j_gather
from repro.kernels.logit_loglik import logit_delta as j_logit
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import batched_loglik, logit_loglik
from repro_torch.kernels.t_test_round import t_test_round_ref

torch.set_num_threads(1)

FP32_TOL = 1e-5  # same products, fp32 sums in another order
EPS32 = float(np.finfo(np.float32).eps)


def pvalue_tol(df, p):
    """How far two float32 evaluations of the reference's Student-t tail may
    lie apart. Both run JAX's recurrence in XLA's operation order; they
    differ only where XLA's log/log1p and PyTorch's round differently by an
    ulp. Inside lgamma(a) that ulp is multiplied by ~a, so the prefactor
    exp(-lbeta) moves by kappa = 8 eps lgamma((df+1)/2) relative (a few ulps
    of the largest lgamma), and the tail by kappa * max(p, 1 - p)."""
    from scipy.special import gammaln

    kappa = 8 * EPS32 * (np.abs(gammaln((np.asarray(df, np.float64) + 1) / 2)) + 1)
    return 1e-5 * p + kappa * np.maximum(p, 1 - p)


def _pair(rng, k, d, dtype=np.float32):
    w = rng.standard_normal((k, d)).astype(dtype)
    return w, (w + 0.3 * rng.standard_normal((k, d))).astype(dtype)


def _labels(rng, shape):
    return np.where(rng.uniform(size=shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("n,d", [(8, 4), (100, 50), (1000, 3), (64, 1), (300, 2)])
def test_logit_delta_matches_pallas(n, d):
    rng = np.random.default_rng(n * 7 + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = _labels(rng, n)
    w, wp = _pair(rng, 1, d)
    want = np.asarray(j_logit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w[0]),
                              jnp.asarray(wp[0]), tile_n=64, interpret=True))
    got = ops.logit_delta(_t(x), _t(y), _t(w[0]), _t(wp[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)
    # the row-index form scores only the requested rows of the pool
    idx = rng.integers(0, n, size=min(n, 37)).astype(np.int32)
    got_idx = ops.logit_delta(_t(x), _t(y), _t(w[0]), _t(wp[0]), idx=_t(idx))
    np.testing.assert_allclose(got_idx.numpy(), want[idx], rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("k,m,d,tile", [
    (1, 8, 4, 8),       # single chain: logit_delta's degenerate case
    (4, 100, 50, 32),   # ragged tail
    (16, 37, 3, 16),    # ragged, K=16
    (7, 5, 2, 8),       # m smaller than the tile
    (3, 20, 1, 8),      # D = 1
    (5, 33, 2, 16),     # D = 2, Fig. 5's width, ragged
])
def test_batched_logit_delta_matches_pallas(k, m, d, tile):
    rng = np.random.default_rng(k * 1000 + m)
    xg = rng.standard_normal((k, m, d)).astype(np.float32)
    yg = _labels(rng, (k, m))
    w, wp = _pair(rng, k, d)
    want = np.asarray(j_batched(*(jnp.asarray(a) for a in (xg, yg, w, wp)),
                                tile_m=tile, interpret=True))
    got = ops.batched_logit_delta(_t(xg), _t(yg), _t(w), _t(wp))
    assert got.shape == (k, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)


def test_gather_and_delta_matches_pallas():
    rng = np.random.default_rng(3)
    n, d, k, m = 500, 10, 3, 40
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = _labels(rng, n)
    idx = rng.integers(0, n, size=(k, m)).astype(np.int32)
    w, wp = _pair(rng, k, d)
    want = np.asarray(j_gather(*(jnp.asarray(a) for a in (x, y, idx, w, wp)),
                               tile_m=16, interpret=True))
    got = ops.gather_and_delta(_t(x), _t(y), _t(idx), _t(w), _t(wp))
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)
    # the wrapper of the kernel module takes the same plain version on the CPU
    direct = batched_loglik.gather_and_delta(_t(x), _t(y), _t(idx), _t(w), _t(wp))
    assert torch.equal(direct, got)


@pytest.mark.parametrize("d", [1, 2])
def test_gather_and_delta_narrow_rows_match_pallas(d):
    """The gathered round at D = 1 and at Fig. 5's D = 2, one row per lane
    on the card."""
    rng = np.random.default_rng(40 + d)
    n, k, m = 300, 4, 37
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = _labels(rng, n)
    idx = rng.integers(0, n, size=(k, m)).astype(np.int32)
    w, wp = _pair(rng, k, d)
    want = np.asarray(j_gather(*(jnp.asarray(a) for a in (x, y, idx, w, wp)),
                               tile_m=16, interpret=True))
    got = ops.gather_and_delta(_t(x), _t(y), _t(idx), _t(w), _t(wp))
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("d", [2, 50])
def test_logit_delta_range_form(d):
    """The exact pass's contiguous form, ``idx=range(start, stop)``, at an
    offset that is no multiple of any tile: equal to the index-tensor form
    on the same rows, and to the Pallas kernel on those rows."""
    rng = np.random.default_rng(60 + d)
    n, start, stop = 1000, 37, 338
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = _labels(rng, n)
    w, wp = _pair(rng, 1, d)
    want = np.asarray(j_logit(jnp.asarray(x[start:stop]), jnp.asarray(y[start:stop]),
                              jnp.asarray(w[0]), jnp.asarray(wp[0]), tile_n=64, interpret=True))
    args = (_t(x), _t(y), _t(w[0]), _t(wp[0]))
    got = ops.logit_delta(*args, idx=range(start, stop))
    by_index = ops.logit_delta(*args, idx=torch.arange(start, stop, dtype=torch.int32))
    assert got.shape == (stop - start,) and torch.equal(got, by_index)
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)
    assert torch.equal(logit_loglik.logit_delta(*args, idx=range(start, stop)), got)
    for p in ("fp32", "bf16"):
        assert torch.equal(ops.logit_delta(*args, idx=range(start, stop), precision=p),
                           ops.logit_delta(*args, idx=torch.arange(start, stop), precision=p))
    for bad in (range(0, n + 1), range(-1, 5), range(0, 10, 2)):
        with pytest.raises(ValueError, match="range"):
            ops.logit_delta(*args, idx=bad)


def test_bf16_matches_jax_bf16_paths():
    """bf16 rows and weights, fp32 accumulation. Against JAX's bf16 Pallas
    path (also fp32 accumulation) the sums of identical products agree to
    fp32 tolerance. JAX's bf16 *reference* path rounds z itself to bf16, so
    against it each delta may move by the bf16 rounding of both sides:
    |dl| <= 2^-8 (|z| + |z'|) (softplus has slope at most 1)."""
    rng = np.random.default_rng(11)
    k, m, d = 4, 100, 50
    xg = (rng.standard_normal((k, m, d)) / np.sqrt(d)).astype(np.float32)
    yg = _labels(rng, (k, m))
    w, wp = _pair(rng, k, d)
    jargs = [jnp.asarray(a) for a in (xg, yg, w, wp)]
    got = ops.batched_logit_delta(_t(xg), _t(yg), _t(w), _t(wp), precision="bf16").numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want_kernel = np.asarray(jops.batched_logit_delta(*jargs, mode="always", precision="bf16"))
        want_ref = np.asarray(jops.batched_logit_delta(*jargs, mode="never", precision="bf16"))
    np.testing.assert_allclose(got, want_kernel, rtol=FP32_TOL, atol=FP32_TOL)
    xb = _t(xg).to(torch.bfloat16).float()
    z = torch.einsum("kmd,kd->km", xb, _t(w).to(torch.bfloat16).float()).abs()
    zp = torch.einsum("kmd,kd->km", xb, _t(wp).to(torch.bfloat16).float()).abs()
    bound = 2.0 ** -8 * (z + zp).numpy() + FP32_TOL
    assert np.all(np.abs(got - want_ref) <= bound)


def test_bf16_decision_flip_rate_bounded():
    """The mixed-precision bar of tests/test_ops_dispatch.py (at most 5% of
    accept/reject decisions flip), on the logit delta: the port's bf16 path
    against JAX's exact fp32 path."""
    rng = np.random.default_rng(0)
    k, m, d, rounds = 8, 256, 20, 30
    flips = total = 0
    for _ in range(rounds):
        xg = (rng.standard_normal((k, m, d)) / np.sqrt(d)).astype(np.float32)
        yg = _labels(rng, (k, m))
        w = rng.standard_normal((k, d)).astype(np.float32)
        wp = (w + 0.05 * rng.standard_normal((k, d))).astype(np.float32)
        logu = np.log(rng.uniform(size=k)).astype(np.float32)
        d32 = np.asarray(jops.batched_logit_delta(*(jnp.asarray(a) for a in (xg, yg, w, wp)),
                                                  mode="never", precision="fp32"))
        d16 = ops.batched_logit_delta(_t(xg), _t(yg), _t(w), _t(wp), precision="bf16").numpy()
        flips += int(((d32.sum(1) > logu) != (d16.sum(1) > logu)).sum())
        total += k
    assert flips / total <= 0.05


def test_dispatch_vocabulary(monkeypatch):
    rng = np.random.default_rng(5)
    x, y = _t(rng.standard_normal((20, 4)).astype(np.float32)), _t(_labels(rng, 20))
    w, wp = (_t(a[0]) for a in _pair(rng, 1, 4))
    _build.reset_launches()
    plain = ref.logit_delta_ref(x, y, w, wp)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        assert torch.equal(ops.logit_delta(x, y, w, wp, mode="ref"), plain)
    with pytest.warns(DeprecationWarning):
        assert ops.normalize_mode("kernel") == "always"
    with pytest.raises(ValueError):
        ops.normalize_mode("sometimes")
    # `always` on CPU tensors raises: there is no kernel to fall back from
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.logit_delta(x, y, w, wp, mode="always")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.gather_and_delta(x, y, torch.zeros((2, 3), dtype=torch.int32), w[None].repeat(2, 1),
                             wp[None].repeat(2, 1), mode="always")
    # auto follows the tensors' device: CPU tensors take the plain version
    assert not ops.use_kernel("auto", x)
    assert torch.equal(ops.logit_delta(x, y, w, wp), plain)
    assert torch.equal(logit_loglik.logit_delta(x, y, w, wp), plain)
    monkeypatch.setenv(ops.ENV_VAR, "always")
    with pytest.raises(RuntimeError):
        ops.logit_delta(x, y, w, wp)
    monkeypatch.setenv(ops.ENV_VAR, "never")
    assert not ops.use_kernel("auto", x)
    monkeypatch.delenv(ops.ENV_VAR)
    assert "dispatch=" in ops.dispatch_summary()
    assert ops.resolve_precision("bf16") == "bf16"
    monkeypatch.setenv(ops.PRECISION_ENV_VAR, "fp16")
    with pytest.raises(ValueError):
        ops.resolve_precision("auto")
    with pytest.raises(ValueError):
        ops.resolve_precision("double")
    assert sum(ops.launches.values()) == 0  # nothing launched on the CPU


def _round_state(rng, k, m, max_count):
    count = rng.integers(0, max_count, size=k).astype(np.float32)
    count[0] = 0
    mean = rng.normal(0, 0.05, k).astype(np.float32)
    m2 = (np.maximum(count - 1, 0) * rng.uniform(0.5, 2.0, k)).astype(np.float32)
    l = (mean[:, None] + rng.standard_normal((k, m))).astype(np.float32)
    valid = rng.uniform(size=(k, m)) < 0.9
    valid[1] = False  # an empty batch keeps its state
    l[2] = 0.125  # a constant batch into an empty accumulator: s == 0
    count[2] = mean[2] = m2[2] = 0
    mu0 = rng.normal(0, 0.05, k).astype(np.float32)
    return count, mean, m2, l, valid, mu0


@pytest.mark.parametrize("max_count", [30, 300])
def test_t_test_round_matches_jax(max_count):
    """The round op's plain version against the reference's Welford merge,
    test_round_decision and lock-step update. Counts and flags exact;
    mean/m2 1e-6 relative; p-values within :func:`pvalue_tol`. The decision runs chain
    by chain (lax.map): the port stops each chain's continued fraction at
    its own convergence, as the reference does for one chain; under vmap
    the reference iterates every lane until the slowest converges, which
    moves these p-values by up to ~1e-4 relative."""
    rng = np.random.default_rng(max_count)
    k, m, n_total, eps = 12, 50, 1000, 0.05
    count, mean, m2, l, valid, mu0 = _round_state(rng, k, m, max_count)
    done0 = np.zeros(k, bool)
    done0[3] = True  # a finished chain is left alone

    w = jstats.Welford(jnp.asarray(count), jnp.asarray(mean), jnp.asarray(m2))
    w2 = jax.vmap(jstats.Welford.merge_batch)(w, jnp.asarray(l), jnp.asarray(valid))
    dec, pv, ok, ex = jax.lax.map(lambda a: j_round_decision(a[0], a[1], n_total, eps),
                                  (w2, jnp.asarray(mu0)))
    act = ~done0
    want = {
        "count": np.where(act, np.asarray(w2.count), count),
        "mean": np.where(act, np.asarray(w2.mean), mean),
        "m2": np.where(act, np.asarray(w2.m2), m2),
        "decision": np.where(act, np.asarray(dec), False),
        "pval": np.where(act, np.asarray(pv), 1.0),
        "done": done0 | np.asarray(ok) | np.asarray(ex),
    }
    st = {name: _t(v.copy()) for name, v in
          (("count", count), ("mean", mean), ("m2", m2))}
    rounds = torch.zeros(k, dtype=torch.int32)
    done, decision, pval = _t(done0.copy()), torch.zeros(k, dtype=torch.bool), torch.ones(k)
    t_test_round_ref(_t(l), _t(valid), st["count"], st["mean"], st["m2"], _t(mu0),
                     torch.full((k,), eps), n_total, 100, rounds, done, decision, pval)
    np.testing.assert_array_equal(st["count"].numpy(), want["count"])
    np.testing.assert_allclose(st["mean"].numpy(), want["mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(st["m2"].numpy(), want["m2"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(decision.numpy(), want["decision"])
    np.testing.assert_array_equal(done.numpy(), want["done"])
    df = np.maximum(want["count"] - 1, 1)
    assert np.all(np.abs(pval.numpy() - want["pval"]) <= pvalue_tol(df, want["pval"]))
    np.testing.assert_array_equal(rounds.numpy(), np.where(act, 1, 0))
