"""The port's LM likelihood (the ``ce`` family and the fused CE kernels'
plain versions) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The JAX
kernels run in interpret mode on the CPU, as ``tests/test_kernels.py`` runs
them; the port's wrappers take their plain PyTorch versions because the
tensors lie on the CPU (the CUDA kernel itself is held against them on the
card, ``tests/test_torch_cuda.py``). With the ``stream`` sampler a
sequential test draws no randomness, so given the reference's table, table'
and log u both packages must reach the same decision after the same rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.kernels.fused_ce import batched_fused_ce as j_batched
from repro.kernels.fused_ce import fused_ce as j_fused
from repro_torch import convert
from repro_torch.core import SubsampledMHConfig, build_target, finish_transition
from repro_torch.core.samplers import sampler_fns, stream_init
from repro_torch.kernels import fused_ce, ops, ref

torch.set_num_threads(1)

FP32_TOL = 1e-5  # the same products, float32 sums in another order


def _inputs(seed, t, d, v, scale=0.5, k=None, per_chain=False):
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    h = (scale * rng.standard_normal(lead + (t, d))).astype(np.float32)
    tab_shape = (k, v, d) if per_chain else (v, d)
    table = (scale * rng.standard_normal(tab_shape)).astype(np.float32)
    targets = rng.integers(0, v, lead + (t,)).astype(np.int32)
    return h, table, targets


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), interpret=True, **kw))


@pytest.mark.parametrize("t,d,v", [(8, 32, 64), (16, 64, 128), (100, 48, 300)])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_fused_ce_matches_pallas(t, d, v, prec):
    """fp32: within 1e-5. bf16: the Pallas kernel keeps float32 logits from
    the bf16 operands (preferred_element_type), as the port's plain version
    does, so the same 1e-5 holds (the JAX package's own oracle rounds the
    logits to bf16 and is 5e-2 away)."""
    h, table, targets = _inputs(t, t, d, v)
    if prec == "bf16":
        jh, jtab = (jnp.asarray(a).astype(jnp.bfloat16) for a in (h, table))
        want = np.asarray(j_fused(jh, jtab, jnp.asarray(targets), tile_t=32, tile_v=64,
                                  interpret=True))
    else:
        want = _jax(j_fused, h, table, targets, tile_t=32, tile_v=64)
    got = ops.fused_ce(_t(h), _t(table), _t(targets), precision=prec)
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)


def test_fused_ce_ragged_and_extreme():
    """Shapes off the tiles (the padding path); 30x logits stay finite and
    within 1e-4, as the reference's test holds its kernel."""
    h, table, targets = _inputs(1, 37, 16, 129, scale=1.0)
    want = _jax(j_fused, h, table, targets, tile_t=16, tile_v=32)
    got = fused_ce.fused_ce(_t(h), _t(table), _t(targets))
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)
    h, table, targets = _inputs(4, 16, 8, 64, scale=30.0)
    want = _jax(j_fused, h, table, targets, tile_t=8, tile_v=16)
    got = ops.fused_ce(_t(h), _t(table), _t(targets)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,t,d,v", [(1, 8, 16, 32), (3, 19, 16, 50), (4, 16, 8, 33)])
@pytest.mark.parametrize("per_chain", [False, True])
def test_batched_fused_ce_matches_pallas(k, t, d, v, per_chain):
    h, table, targets = _inputs(k * 10 + t, t, d, v, scale=0.4, k=k, per_chain=per_chain)
    want = _jax(j_batched, h, table, targets, tile_t=8, tile_v=16)
    got = ops.batched_fused_ce(_t(h), _t(table), _t(targets))
    assert got.shape == (k, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)
    # each chain's row is the single-chain form on its slice
    for c in range(k):
        row = ops.fused_ce(_t(h[c]), _t(table[c] if per_chain else table), _t(targets[c]))
        np.testing.assert_allclose(got[c].numpy(), row.numpy(), rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("per_chain", [False, True])
def test_gather_form_matches_gathered_pallas(per_chain):
    """Rows idx (K, m) of a shared (N, D) pool, scored by the port's gather
    form, equal JAX's batched kernel on the rows gathered first; the
    single-chain form with idx equals it too."""
    rng = np.random.default_rng(9)
    n, d, v, k, m = 90, 16, 70, 3, 21
    pool = (0.5 * rng.standard_normal((n, d))).astype(np.float32)
    tgt = rng.integers(0, v, n).astype(np.int32)
    table = (0.5 * rng.standard_normal((k, v, d) if per_chain else (v, d))).astype(np.float32)
    idx = rng.integers(0, n, (k, m)).astype(np.int32)
    want = _jax(j_batched, pool[idx], table, tgt[idx], tile_t=8, tile_v=16)
    got = ops.gather_fused_ce(_t(pool), _t(tgt), _t(idx), _t(table))
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)
    one = ops.fused_ce(_t(pool), _t(table[0] if per_chain else table), _t(tgt), idx=_t(idx[0]))
    np.testing.assert_allclose(one.numpy(), want[0], rtol=FP32_TOL, atol=FP32_TOL)


def test_always_on_cpu_raises_and_plain_versions_are_the_cpu_route():
    h, table, targets = (_t(a) for a in _inputs(2, 6, 8, 20))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.fused_ce(h, table, targets, mode="always")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.batched_fused_ce(h[None], table, targets[None], mode="always")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.gather_fused_ce(h, targets, idx, table, mode="always")
    ops.reset_launches()
    torch.testing.assert_close(ops.fused_ce(h, table, targets),
                               ref.fused_ce_ref(h, table, targets))
    assert sum(ops.launches.values()) == 0


def _bf16_terms(w, n):
    """The first n exact bf16 terms of fp32 w: hi, mid, lo (as the CUDA
    kernel splits the table on the tensor cores' way in)."""
    terms, rest = [], w.clone()
    for _ in range(n):
        t = rest.to(torch.bfloat16)
        terms.append(t)
        rest = rest - t.float()
    return terms


def test_bf16_split_of_the_table_matches_pallas():
    """The CUDA kernel's arithmetic, here where no kernel runs: at the path's
    width (T = 100 bf16 rows, D = 4096, table 0.02 N(0, 1)) the logits summed
    from the bf16 products of h with the three terms of the fp32 table
    (hi, mid, lo; each product exact in fp32, fp32 sums) give per-token
    values within the card's tolerance, 1e-4 log V, of the JAX ``fused_ce``
    in interpret mode; the hi term alone (one bf16 pass) does not."""
    rng = np.random.default_rng(14)
    t, d, v = 100, 4096, 1024
    h = torch.tensor(rng.standard_normal((t, d)), dtype=torch.float32).to(torch.bfloat16)
    table = torch.tensor(0.02 * rng.standard_normal((v, d)), dtype=torch.float32)
    targets = rng.integers(0, v, t).astype(np.int32)
    want = _jax(j_fused, h.float().numpy(), table.numpy(), targets, tile_t=104, tile_v=256)
    tol = 1e-4 * np.log(v)
    hf = h.float()

    def per_token(n_terms):
        logits = sum(hf @ term.float().T for term in _bf16_terms(table, n_terms))
        return torch.log_softmax(logits, -1)[torch.arange(t), torch.tensor(targets).long()]

    three = per_token(3).numpy()
    np.testing.assert_allclose(three, want, rtol=0, atol=tol)
    assert np.abs(per_token(1).numpy() - want).max() > tol


# ---------------------------------------------------------------------------
# the ce family
# ---------------------------------------------------------------------------


def _jax_ce_target(h, targets, n, prior=True):
    prior_fn = (lambda tab: -0.5 * jnp.sum(tab ** 2)) if prior else (lambda tab: jnp.zeros(()))
    return J.build_target("ce", (jnp.asarray(h), jnp.asarray(targets)), n, prior_logpdf=prior_fn)


def _port_ce_target(h, targets, n):
    data = convert.ce_data(h, targets, device="cpu")
    return build_target("ce", data, n,
                        prior_logpdf=lambda tab: -0.5 * (tab ** 2).sum((-2, -1)))


def test_ce_family_matches_jax_build_target():
    """log_local (one chain) and log_local_ensemble (K chains, per-chain
    tables) against the reference's ``build_target("ce", ...)``, as
    ``tests/test_target_builder.py`` checks its own."""
    rng = np.random.default_rng(5)
    n, d, v, k, m = 60, 8, 30, 3, 16
    h = (0.3 * rng.standard_normal((n, d))).astype(np.float32)
    targets = rng.integers(0, v, n).astype(np.int32)
    tab0 = (0.3 * rng.standard_normal((v, d))).astype(np.float32)
    tab1 = (0.3 * rng.standard_normal((v, d))).astype(np.float32)
    jt, tt = _jax_ce_target(h, targets, n, prior=False), _port_ce_target(h, targets, n)
    assert tt.family == "ce" and tt.log_local_ensemble is not None
    idx = np.arange(40, dtype=np.int32)
    want = np.asarray(jt.log_local(jnp.asarray(tab0), jnp.asarray(tab1), jnp.asarray(idx)))
    got = tt.log_local(_t(tab0), _t(tab1), _t(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)
    idxb = rng.integers(0, n, (k, m)).astype(np.int32)
    tabs0 = np.stack([tab0 + 0.01 * c for c in range(k)])
    tabs1 = np.stack([tab1 - 0.01 * c for c in range(k)])
    want = np.asarray(jt.log_local_ensemble(jnp.asarray(tabs0), jnp.asarray(tabs1),
                                            jnp.asarray(idxb)))
    got = tt.log_local_ensemble(_t(tabs0), _t(tabs1), _t(idxb))
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_TOL, atol=FP32_TOL)
    got_never = tt.log_local_ensemble(_t(tabs0), _t(tabs1), _t(idxb), mode="never")
    torch.testing.assert_close(got_never, got)
    # log_density: the prior plus every section's log-likelihood
    want = float(jt.log_density(jnp.asarray(tab0)))
    assert abs(float(tt.log_density(_t(tab0))) + 0.5 * float((tab0 ** 2).sum()) - want) \
        <= 1e-5 * abs(want)


def test_sequential_test_matches_jax_on_stream():
    """A whole single-chain transition of the ce target with the stream
    sampler: given the reference's table, table' and log u, the same
    decision, rounds and n_evaluated; mu_hat within 1e-5, mu0 within the
    float32 rounding of the prior's sums."""
    rng = np.random.default_rng(6)
    n, d, v, count = 400, 16, 50, 16
    h = (0.5 * rng.standard_normal((n, d))).astype(np.float32)
    targets = rng.integers(0, v, n).astype(np.int32)
    tab = (0.5 * rng.standard_normal((v, d))).astype(np.float32)
    jt, tt = _jax_ce_target(h, targets, n), _port_ce_target(h, targets, n)
    cfg_kw = dict(batch_size=40, epsilon=0.05, sampler="stream")
    rw = J.RandomWalk(0.02)
    state0, step = J.make_kernel(jt, rw, J.SubsampledMHConfig(**cfg_kw))

    def one(key, th):
        th_p, _, log_u, _ = J.propose_and_mu0(key, th, jt, rw)
        _, _, info = step(key, th, state0)
        return th_p, log_u, info

    keys = jax.random.split(jax.random.key(7), count)
    th_p, log_u, want = jax.jit(jax.vmap(one, in_axes=(0, None)))(keys, jnp.asarray(tab))
    reset_fn, draw_fn = sampler_fns("stream")
    got = {f: [] for f in ("accepted", "n_evaluated", "rounds", "mu0", "mu_hat")}
    for i in range(count):
        th, thp, lu = _t(tab), _t(np.asarray(th_p)[i]), _t(np.asarray(log_u)[i])
        mu0 = (lu - tt.log_global(th, thp)) / n
        _, _, info = finish_transition(None, th, thp, mu0, lu, stream_init(n, device="cpu"), tt,
                                       SubsampledMHConfig(**cfg_kw), reset_fn, draw_fn)
        for f in got:
            got[f].append(float(getattr(info, f)))
    for f in ("accepted", "n_evaluated", "rounds"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f), np.float64), err_msg=f)
    # mu0 carries the prior's difference of two float32 sums of squares
    # (~200 each here): a few ulps of those sums, over N
    sq_ulp = float(np.finfo(np.float32).eps) * float((tab.astype(np.float64) ** 2).sum())
    np.testing.assert_allclose(got["mu0"], np.asarray(want.mu0), rtol=1e-5, atol=8 * sq_ulp / n)
    np.testing.assert_allclose(got["mu_hat"], np.asarray(want.mu_hat), rtol=1e-5, atol=1e-5)
    assert 0 < np.mean(got["accepted"]) < 1 and len(set(got["rounds"])) > 1
