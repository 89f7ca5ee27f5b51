"""The port's stochastic-volatility slice against the JAX package.

Inputs are made with numpy (or by the JAX package's ``synth``) from a seed
and handed to both packages. The JAX AR(1) kernel runs in interpret mode on
the CPU, as ``tests/test_kernels.py`` runs it; the port's wrappers take their
plain PyTorch versions because the tensors lie on the CPU. With the
``stream`` sampler a sequential test draws no randomness, so given the
reference's theta, theta' and log u both packages must reach the same
decision after the same rounds.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.experiments import stochvol as jsv
from repro.kernels import ops as jops
from repro.kernels.gaussian_ar1 import batched_gaussian_ar1_delta as j_ar1
from repro.kernels.ref import batched_gaussian_ar1_delta_ref as j_ar1_ref
from repro_torch import convert
from repro_torch.core import (
    ChainEnsemble,
    SubsampledMHConfig,
    SubsampledMHOp,
    build_target,
    cycle,
    exact_decide,
    finish_transition,
    make_sampler,
    subsampled_mh_step,
)
from repro_torch.core.samplers import sampler_fns, stream_init
from repro_torch.experiments import stochvol
from repro_torch.kernels import gaussian_ar1, ops

torch.set_num_threads(1)
FP32_TOL = 1e-6  # the same float32 operations in the same order


def _term_scale(xt, xp, phi, s2, phi_p, s2_p):
    """|log N(xt | phi xp, s2)| + |log N(xt | phi' xp, s2')| without the 2 pi
    constant: the delta is the difference of these two terms, so one ulp of
    either moves it by ~6e-8 of this scale. XLA's compiled arithmetic (the
    Pallas kernel in interpret mode) rounds some steps differently from the
    eager reference, which the port repeats operation for operation."""
    term = lambda p_, s_: 0.5 * ((xt - p_[:, None] * xp) ** 2 / s_[:, None]
                                 + np.abs(np.log(s_[:, None])))
    return term(phi, s2) + term(phi_p, s2_p)


def _t(a):
    return torch.tensor(np.asarray(a))


def _params(rng, k):
    phi = rng.uniform(0.3, 0.99, k).astype(np.float32)
    s2 = rng.uniform(1e-3, 0.2, k).astype(np.float32)
    return phi, s2, (phi + 0.05).astype(np.float32), (s2 * 1.3).astype(np.float32)


@pytest.fixture(scope="module")
def sv():
    """One stochvol data set from the JAX package, in both packages."""
    data = jsv.synth(jax.random.key(3), num_series=150, length=5, phi=0.95, sigma=0.1)
    tdata = convert.sv_data(np.asarray(data.obs), np.asarray(data.h_true), device="cpu")
    return {"j": data, "t": tdata, "n": 750}


# ---------------------------------------------------------------------------
# the AR(1) pair delta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,m", [(1, 7), (3, 20), (4, 300)])
def test_ar1_delta_matches_pallas_and_ref(k, m):
    rng = np.random.default_rng(k * 100 + m)
    xt, xp = (rng.standard_normal((k, m)).astype(np.float32) for _ in range(2))
    par = _params(rng, k)
    jargs = [jnp.asarray(a) for a in (xt, xp, *par)]
    want_kernel = np.asarray(j_ar1(*jargs, tile_m=8, interpret=True))
    want_ref = np.asarray(j_ar1_ref(*jargs))
    got = ops.batched_gaussian_ar1_delta(_t(xt), _t(xp), *(_t(p) for p in par)).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=FP32_TOL, atol=FP32_TOL)
    assert np.all(np.abs(got - want_kernel) <= FP32_TOL * _term_scale(xt, xp, *par) + FP32_TOL)
    # the gather form on a shared (N,) pool and on per-chain (K, N) pools
    n = 2 * m + 3
    pool_t, pool_p = (rng.standard_normal((k, n)).astype(np.float32) for _ in range(2))
    idx = rng.integers(0, n, size=(k, m)).astype(np.int32)
    shared = ops.gather_ar1_delta(_t(pool_t[0]), _t(pool_p[0]), _t(idx), *(_t(p) for p in par))
    want = j_ar1_ref(jnp.asarray(pool_t[0])[idx], jnp.asarray(pool_p[0])[idx], *jargs[2:])
    np.testing.assert_allclose(shared.numpy(), np.asarray(want), rtol=FP32_TOL, atol=FP32_TOL)
    per_chain = ops.gather_ar1_delta(_t(pool_t), _t(pool_p), _t(idx), *(_t(p) for p in par))
    rows = np.arange(k)[:, None]
    want = j_ar1_ref(jnp.asarray(pool_t[rows, idx]), jnp.asarray(pool_p[rows, idx]), *jargs[2:])
    np.testing.assert_allclose(per_chain.numpy(), np.asarray(want), rtol=FP32_TOL, atol=FP32_TOL)
    assert torch.equal(gaussian_ar1.gather_ar1_delta(_t(pool_t), _t(pool_p), _t(idx),
                                                     *(_t(p) for p in par)), per_chain)


def test_ar1_delta_bf16_matches_jax_and_flip_bound():
    """bf16 sections, fp32 arithmetic: the port's bf16 path equals JAX's
    bf16 path to fp32 rounding (both upcast the same bf16 values), and
    against JAX's exact fp32 path it flips at most 5% of accept/reject
    decisions (the bar of tests/test_ops_dispatch.py)."""
    rng = np.random.default_rng(0)
    k, m = 8, 256
    flips = total = 0
    for r in range(50):
        xt, xp = ((rng.standard_normal((k, m)) * 0.3).astype(np.float32) for _ in range(2))
        phi = rng.uniform(0.5, 0.99, k).astype(np.float32)
        s2 = rng.uniform(0.01, 0.2, k).astype(np.float32)
        phi_p = (phi + rng.normal(0, 0.02, k)).astype(np.float32)
        s2_p = (s2 * rng.uniform(0.9, 1.1, k)).astype(np.float32)
        logu = np.log(rng.uniform(size=k)).astype(np.float32)
        jargs = [jnp.asarray(a) for a in (xt, xp, phi, s2, phi_p, s2_p)]
        targs = [_t(a) for a in (xt, xp, phi, s2, phi_p, s2_p)]
        d16 = ops.batched_gaussian_ar1_delta(*targs, precision="bf16").numpy()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            d32 = np.asarray(jops.batched_gaussian_ar1_delta(*jargs, mode="never", precision="fp32"))
            if r == 0:
                j16 = np.asarray(jops.batched_gaussian_ar1_delta(*jargs, mode="never",
                                                                 precision="bf16"))
                np.testing.assert_allclose(d16, j16, rtol=FP32_TOL, atol=FP32_TOL)
        flips += int(((d32.sum(1) > logu) != (d16.sum(1) > logu)).sum())
        total += k
    assert flips / total <= 0.05


def test_ar1_delta_out_of_support_is_finite():
    """Negative / zero sigma^2 proposals are rejected by the -inf prior, but
    the local values the test already drew stay finite (the clip guard),
    equal to JAX's Pallas kernel and reference."""
    rng = np.random.default_rng(1)
    k, m = 2, 16
    xt, xp = (rng.standard_normal((k, m)).astype(np.float32) for _ in range(2))
    phi, s2 = np.full(k, 0.9, np.float32), np.full(k, 0.05, np.float32)
    s2_bad = np.asarray([-0.01, 0.0], np.float32)
    jargs = [jnp.asarray(a) for a in (xt, xp, phi, s2, phi, s2_bad)]
    got = ops.batched_gaussian_ar1_delta(*(_t(a) for a in (xt, xp, phi, s2, phi, s2_bad))).numpy()
    assert np.isfinite(got).all()
    want_kernel = np.asarray(j_ar1(*jargs, tile_m=8, interpret=True))
    assert np.all(np.abs(got - want_kernel) <= FP32_TOL * _term_scale(
        xt, xp, phi, s2, phi, np.maximum(s2_bad, 1e-12)) + FP32_TOL)
    np.testing.assert_allclose(got, np.asarray(j_ar1_ref(*jargs)), rtol=FP32_TOL, atol=FP32_TOL)


def test_fy_swaps_on_host_equal_the_tensor_loop():
    """The plain Fisher-Yates draw swaps a CPU buffer through numpy and any
    other buffer through tensor ops: the same swaps, in the same order,
    including repeated and self-swaps."""
    from repro_torch.kernels.fy_draw import _swap_in_place, _swap_on_host

    rng = np.random.default_rng(6)
    k, cap, m = 5, 40, 30
    p = torch.tensor(np.minimum(np.arange(m)[None] + rng.integers(0, 15, (k, 1)), cap - 1))
    j = torch.minimum(p + torch.tensor(rng.integers(0, 12, (k, m))), torch.tensor(cap - 1))
    j[1] = p[1]  # an inactive chain swaps each position with itself
    start = torch.arange(cap, dtype=torch.int32).repeat(k, 1)
    a, b = start.clone(), start.clone()
    _swap_on_host(a, p, j)
    _swap_in_place(b, p, j)
    assert torch.equal(a, b) and not torch.equal(a, start) and torch.equal(a[1], start[1])


# ---------------------------------------------------------------------------
# the gaussian_ar1 family and the stochvol targets
# ---------------------------------------------------------------------------


def _theta(phi, s2, h=None, lib="t"):
    mk = (lambda v: jnp.asarray(v, jnp.float32)) if lib == "j" else \
        (lambda v: torch.tensor(np.asarray(v, np.float32)))
    out = {"phi": mk(phi), "sigma2": mk(s2)}
    if h is not None:
        out["h"] = mk(h)
    return out


def test_gaussian_ar1_family_matches_jax(sv):
    """log_local of the closure target and of the joint target (callable
    data on theta["h"]), and log_local_ensemble with per-chain paths,
    against make_param_target / make_joint_param_target."""
    h = np.asarray(sv["j"].h_true)
    n = sv["n"]
    jt = jsv.make_param_target(sv["j"].h_true, "phi")
    jj = jsv.make_joint_param_target(150, 5)
    tt = stochvol.make_param_target(sv["t"].h_true, "phi")
    tj = stochvol.make_joint_param_target(150, 5, device="cpu")
    assert tt.family == tj.family == "gaussian_ar1" and tj.num_sections == n
    idx = np.arange(0, n, 3, dtype=np.int32)
    j0, j1 = _theta(0.9, 0.02, h, "j"), _theta(0.85, 0.03, h, "j")
    t0, t1 = _theta(0.9, 0.02, h), _theta(0.85, 0.03, h)
    want = np.asarray(jt.log_local(j0, j1, jnp.asarray(idx)))
    for target in (tt, tj):
        np.testing.assert_allclose(target.log_local(t0, t1, _t(idx)).numpy(), want,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(target.local_round(t0, t1)(_t(idx)).numpy(), want,
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tj.log_global(t0, t1)), float(jj.log_global(j0, j1)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tt.log_density(t0)), float(jt.log_density(j0)), rtol=1e-5)
    # ensemble form: K = 3 chains with their own paths and parameters
    rng = np.random.default_rng(2)
    k = 3
    hk = (h[None] + 0.05 * rng.standard_normal((k,) + h.shape)).astype(np.float32)
    phi, s2, phi_p, s2_p = _params(rng, k)
    idxk = rng.integers(0, n, size=(k, 40)).astype(np.int32)
    want = np.asarray(jj.log_local_ensemble(_theta(phi, s2, hk, "j"), _theta(phi_p, s2_p, hk, "j"),
                                            jnp.asarray(idxk)))
    th0, th1 = _theta(phi, s2, hk), _theta(phi_p, s2_p, hk)
    got = tj.log_local_ensemble(th0, th1, _t(idxk))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(tj.local_round(th0, th1, ensemble=True)(_t(idxk)), got)


@pytest.mark.parametrize("start,stop", [(0, 750), (3, 400), (749, 750)])
def test_gaussian_ar1_family_range_form(sv, start, stop):
    """The family's one-chain delta on ``range(start, stop)`` (the exact
    pass's form, read with no index tensor) equals its index form on the
    same sections bit for bit, and the JAX family's log_local within the
    tolerance of test_gaussian_ar1_family_matches_jax, on the closure target
    and on the joint target."""
    h = np.asarray(sv["j"].h_true)
    jt = jsv.make_param_target(sv["j"].h_true, "phi")
    tt = stochvol.make_param_target(sv["t"].h_true, "phi")
    tj = stochvol.make_joint_param_target(150, 5, device="cpu")
    assert tt.range_sections and tj.range_sections
    want = np.asarray(jt.log_local(_theta(0.9, 0.02, h, "j"), _theta(0.85, 0.03, h, "j"),
                                   jnp.arange(start, stop, dtype=jnp.int32)))
    t0, t1 = _theta(0.9, 0.02, h), _theta(0.85, 0.03, h)
    for target in (tt, tj):
        got = target.log_local(t0, t1, range(start, stop))
        by_index = target.log_local(t0, t1, torch.arange(start, stop, dtype=torch.int32))
        assert got.shape == (stop - start,) and torch.equal(got, by_index)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_ar1_delta_range_on_shared_pools():
    """ops.gather_ar1_delta and the kernel module's wrapper take a range of
    shared (N,) pools -> (1, m), equal to the index form in fp32 and bf16;
    an empty run is (1, 0); runs outside the pool, with a step, or of
    per-chain (K, N) pools raise."""
    rng = np.random.default_rng(8)
    n = 301
    xt, xp = (_t((0.3 * rng.standard_normal(n)).astype(np.float32)) for _ in range(2))
    par = [_t(np.asarray([v], np.float32)) for v in (0.95, 0.01, 0.93, 0.012)]
    for start, stop in [(0, n), (7, 200), (n - 1, n)]:
        idx = torch.arange(start, stop, dtype=torch.int32)[None]
        for prec in ("fp32", "bf16"):
            got = ops.gather_ar1_delta(xt, xp, range(start, stop), *par, precision=prec)
            assert got.shape == (1, stop - start)
            assert torch.equal(got, ops.gather_ar1_delta(xt, xp, idx, *par, precision=prec))
        assert torch.equal(gaussian_ar1.gather_ar1_delta(xt, xp, range(start, stop), *par),
                           ops.gather_ar1_delta(xt, xp, idx, *par))
    assert ops.gather_ar1_delta(xt, xp, range(9, 9), *par).shape == (1, 0)
    for bad in (range(0, n + 1), range(-1, 5), range(0, 10, 2)):
        with pytest.raises(ValueError):
            ops.gather_ar1_delta(xt, xp, bad, *par)
    with pytest.raises(ValueError, match="shared"):
        ops.gather_ar1_delta(xt[None], xp[None], range(0, 5), *par)


@pytest.mark.parametrize("chunk_size", [None, 256, 77])
def test_exact_decide_ar1_range_form_matches_index_tensor(sv, chunk_size):
    """exact_decide on a make_param_target target scores the full pass's
    chunks as ranges; the same log_local behind a target that gets index
    tensors (the reference's ``arange`` chunks) reaches the same total
    (mu_hat), decision, n_evaluated and rounds."""
    tt = stochvol.make_param_target(sv["t"].h_true, "phi")
    n = tt.num_sections
    by_index = build_target(None, None, n, log_global=tt.log_global, log_local=tt.log_local)
    assert tt.range_sections and not by_index.range_sections
    rng = np.random.default_rng(4)
    decisions = set()
    for _ in range(12):
        phi, s2 = rng.uniform(0.85, 0.99), rng.uniform(0.005, 0.02)
        th = _theta(phi, s2)
        thp = _theta(phi + rng.normal(0, 0.01), s2 * rng.uniform(0.9, 1.1))
        g = tt.log_global(th, thp)
        lu = torch.tensor(np.log(rng.uniform()), dtype=torch.float32)
        (a, ia), (b, ib) = (exact_decide(th, thp, g, lu, t, chunk_size=chunk_size)
                            for t in (tt, by_index))
        assert all(torch.equal(a[v], b[v]) for v in ("phi", "sigma2"))
        assert bool(ia.accepted) == bool(ib.accepted)
        assert torch.equal(ia.mu_hat, ib.mu_hat) and int(ia.n_evaluated) == int(ib.n_evaluated) == n
        assert int(ia.rounds) == int(ib.rounds)
        decisions.add(bool(ia.accepted))
    assert decisions == {True, False}


def test_sections_built_once_per_transition():
    """The joint target's pools derive from theta["h"]: a bound round
    evaluates them once, however many rounds the test runs."""
    calls = []
    target = stochvol.make_joint_param_target(4, 5, device="cpu")
    data_fn = target.bind
    th = _theta(0.9, 0.02, np.zeros((4, 5)))

    def counting(theta, theta_p, ensemble=False, mode="auto"):
        calls.append(1)
        return data_fn(theta, theta_p, ensemble, mode)

    import dataclasses

    counted = dataclasses.replace(target, bind=counting)
    cfg = SubsampledMHConfig(batch_size=2, epsilon=1e-9, sampler="fy")
    state0, reset, draw = make_sampler("fy", 20, device="cpu")
    _, _, info = subsampled_mh_step(torch.Generator().manual_seed(0), th, state0, counted,
                                    stochvol.SingleLeafRW("phi", 0.05), cfg, reset, draw)
    assert int(info.rounds) > 1 and len(calls) == 1


def test_sequential_test_matches_jax_on_stream(sv):
    """The AR(1) target with the stream sampler over a pre-permuted pool:
    given the reference's theta, theta' and log u, the same decision,
    n_evaluated and rounds; mu0 and mu_hat within float32 rounding."""
    n, count = sv["n"], 100
    perm_key = jax.random.key(11)
    jt = jsv.make_param_target(sv["j"].h_true, "phi", permute_key=perm_key)
    perm = np.asarray(jax.random.permutation(perm_key, n))
    tt = stochvol.make_param_target(sv["t"].h_true, "phi", permute_key=perm)
    rng = np.random.default_rng(4)
    cfg_kw = dict(batch_size=50, epsilon=0.05, sampler="stream")
    jcfg = J.SubsampledMHConfig(**cfg_kw)
    got, want = {f: [] for f in ("accepted", "n_evaluated", "rounds", "mu0", "mu_hat")}, []
    reset_fn, draw_fn = sampler_fns("stream")
    for leaf, sig in (("phi", 0.05), ("sigma2", 0.004)):
        rw = jsv.SingleLeafRW(leaf, sig)
        state0, step = J.make_kernel(jt, rw, jcfg)

        def one(args, rw=rw, step=step, state0=state0):
            key, th = args
            th_p, _, log_u, _ = J.propose_and_mu0(key, th, jt, rw)
            _, _, info = step(key, th, state0)
            return th_p, log_u, info

        phis = rng.uniform(0.85, 0.99, count // 2).astype(np.float32)
        s2s = rng.uniform(0.006, 0.015, count // 2).astype(np.float32)
        keys = jax.random.split(jax.random.key(5 if leaf == "phi" else 6), count // 2)
        th_p, log_u, info = jax.jit(lambda ks, th: jax.lax.map(one, (ks, th)))(
            keys, _theta(phis, s2s, lib="j"))
        want.append(info)
        for i in range(count // 2):
            th = _theta(phis[i], s2s[i])
            thp = {name: _t(np.asarray(v)[i]) for name, v in th_p.items()}
            lu = _t(np.asarray(log_u)[i])
            mu0 = (lu - tt.log_global(th, thp)) / n
            _, _, tinfo = finish_transition(None, th, thp, mu0, lu, stream_init(n, device="cpu"),
                                            tt, SubsampledMHConfig(**cfg_kw), reset_fn, draw_fn)
            for f in got:
                got[f].append(float(getattr(tinfo, f)))
    want = {f: np.concatenate([np.asarray(getattr(w, f), np.float64) for w in want])
            for f in got}
    for f in ("accepted", "n_evaluated", "rounds"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["mu0"], want["mu0"], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got["mu_hat"], want["mu_hat"], rtol=1e-5, atol=1e-6)
    assert 0 < np.mean(got["accepted"]) < 1


@pytest.mark.parametrize("bad", [{"phi": 1.7}, {"sigma2": -0.01}])
def test_out_of_support_proposal_rejected_in_one_round(sv, bad):
    """phi outside (0, 1) or sigma^2 <= 0: log_global = -inf, mu0 = +inf,
    and the test rejects after its first round with the reference's
    n_evaluated, without NaN."""
    n = sv["n"]
    jt = jsv.make_param_target(sv["j"].h_true, "phi")
    tt = stochvol.make_param_target(sv["t"].h_true, "phi")
    (leaf, value), = bad.items()
    jcfg = J.SubsampledMHConfig(batch_size=50, epsilon=0.05, sampler="fy")
    s0, reset, draw = J.make_sampler("fy", n)
    jprop = lambda key, th: ({**th, leaf: jnp.asarray(value, jnp.float32)}, jnp.zeros(()))
    _, _, jinfo = J.subsampled_mh_step(jax.random.key(0), _theta(0.9, 0.01, lib="j"), s0, jt,
                                       jprop, jcfg, reset, draw)
    cfg = SubsampledMHConfig(batch_size=50, epsilon=0.05, sampler="fy")
    t0, treset, tdraw = make_sampler("fy", n, device="cpu")
    tprop = lambda gen, th: ({**th, leaf: torch.tensor(value)}, torch.zeros(()))
    th = _theta(0.9, 0.01)
    new, _, info = subsampled_mh_step(torch.Generator().manual_seed(0), th, t0, tt, tprop, cfg,
                                      treset, tdraw)
    assert not bool(info.accepted) and not bool(jinfo.accepted)
    assert int(info.rounds) == int(jinfo.rounds) == 1
    assert int(info.n_evaluated) == int(jinfo.n_evaluated) == 50
    assert float(info.mu0) == np.inf and float(info.pvalue) == 0.0
    assert np.isfinite(float(info.mu_hat)) and float(new[leaf]) == float(th[leaf])


# ---------------------------------------------------------------------------
# composite cycles and the ensemble
# ---------------------------------------------------------------------------


def test_ensemble_of_one_equals_sequential_cycle():
    """The stochvol ensemble at K = 1 reproduces run_posterior_sequential
    bit for bit: particle-Gibbs sweep, phi move, sigma2 move, every step."""
    data = stochvol.synth(7, num_series=30, length=5, device="cpu")
    kw = dict(batch_size=50, epsilon=0.05, num_particles=12, device="cpu")
    _, samples, infos, _ = stochvol.run_posterior_ensemble(8, data, num_chains=1, num_steps=25,
                                                           **kw)
    _, s_seq, i_seq = stochvol.run_posterior_sequential(8, data, 25, **kw)
    for leaf in ("phi", "sigma2"):
        assert torch.equal(samples[leaf][0], s_seq[leaf])
    for name in ("phi", "sigma2"):
        for f in ("accepted", "n_evaluated", "rounds", "mu_hat", "mu0", "log_u"):
            assert torch.equal(getattr(infos[name], f)[0], getattr(i_seq[name], f)), f"{name}.{f}"


def test_cycle_of_one_equals_bare_ensemble(sv):
    target = stochvol.make_param_target(sv["t"].h_true, "phi")
    cfg = SubsampledMHConfig(batch_size=50, epsilon=0.05, sampler="fy")
    rw = stochvol.SingleLeafRW("phi", 0.02)
    k, steps = 3, 20
    th0 = _theta(0.8, 0.01)
    bare = ChainEnsemble(target, rw, k, config=cfg, device="cpu")
    comp = ChainEnsemble(num_chains=k, transition=cycle([SubsampledMHOp(target, rw, cfg, "phi")]),
                         device="cpu")
    _, s_b, i_b = bare.run(7, bare.init(th0), steps)
    _, s_c, i_c = comp.run(7, comp.init(th0), steps)
    for leaf in ("phi", "sigma2"):
        assert torch.equal(s_b[leaf], s_c[leaf])
    for f in ("accepted", "n_evaluated", "rounds", "mu_hat", "mu0", "log_u"):
        assert torch.equal(getattr(i_b, f), getattr(i_c["phi"], f)), f


def test_composite_validation():
    data = stochvol.synth(0, num_series=4, length=5, device="cpu")
    cyc = stochvol.make_inference_cycle(data.obs, batch_size=5, num_particles=4)
    target = stochvol.make_joint_param_target(4, 5, device="cpu")
    for kw in (dict(target=target, proposal=stochvol.SingleLeafRW("phi", 0.1)),
               dict(kernel="exact"), dict(config=SubsampledMHConfig()), dict(chunk_size=4),
               dict(stepping="masked"), dict(schedule=object()), dict(shard=True)):
        with pytest.raises(ValueError):
            ChainEnsemble(num_chains=2, transition=cyc, device="cpu", **kw)
    with pytest.raises(TypeError):
        ChainEnsemble(num_chains=2, transition=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="threefry"):
        stochvol.make_inference_cycle(data.obs, sweep="compat")
    with pytest.raises(ValueError):
        stochvol.resolve_sweep("sometimes")


def test_opaque_sweep_cycle_runs():
    data = stochvol.synth(1, num_series=6, length=4, device="cpu")
    _, samples, infos, diag = stochvol.run_posterior_ensemble(
        2, data, num_chains=2, num_steps=8, batch_size=6, num_particles=5, sweep="opaque",
        device="cpu")
    assert samples["phi"].shape == (2, 8) and bool(torch.isfinite(samples["sigma2"]).all())
    assert set(diag["accept_rate"]) == {"phi", "sigma2"}


def test_parameters_recovered_given_states(sv):
    """Sec 4.3 parameter moves with h fixed at the JAX package's true paths
    (S = 150, T = 5): the port's subsampled-MH chain over (phi, sigma2) lands
    in the windows of tests/test_experiments.py."""
    target = stochvol.make_param_target(sv["t"].h_true, "phi")
    cfg = SubsampledMHConfig(batch_size=100, epsilon=0.05)
    ops_ = [SubsampledMHOp(target, stochvol.SingleLeafRW("phi", 0.05), cfg, "phi"),
            SubsampledMHOp(target, stochvol.SingleLeafRW("sigma2", 0.004), cfg, "sigma2")]
    from repro_torch.core import run_cycle_sequential

    _, samples, _ = run_cycle_sequential(4, _theta(0.8, 0.02), cycle(ops_), 200, device="cpu")
    phi_hat = float(samples["phi"][50:].mean())
    sig_hat = float(samples["sigma2"][50:].mean()) ** 0.5
    assert 0.8 < phi_hat <= 1.0, phi_hat
    assert 0.06 < sig_hat < 0.16, sig_hat


def test_joint_posterior_matches_jax_end_to_end():
    """The whole program, sweep then phi move then sigma^2 move, in both
    packages: K chains each, from the same start, on the JAX package's data.
    Within a package the chains are independent and identically
    distributed, so each chain's mean over the second half is one
    independent draw whatever the mixing. The two packages' averages of
    those draws must agree within 4 combined standard errors, for phi and
    for sigma^2; a sweep that left h alone, or moves scored on stale pools,
    shift sigma^2 by many of them (a sweep that returns h unchanged moves
    the sigma^2 statistic past 6 of them at this size)."""
    k, steps = 12, 120
    kw = dict(batch_size=25, epsilon=0.05, num_particles=12)
    data = jsv.synth(jax.random.key(21), num_series=20, length=5)
    tdata = convert.sv_data(np.asarray(data.obs), np.asarray(data.h_true), device="cpu")
    _, js, _, _ = jsv.run_posterior_ensemble(jax.random.split(jax.random.key(22), k), data,
                                             num_chains=k, num_steps=steps, **kw)
    _, ts, _, _ = stochvol.run_posterior_ensemble(23, tdata, num_chains=k, num_steps=steps,
                                                  device="cpu", **kw)
    for leaf in ("phi", "sigma2"):
        draws = [np.asarray(s[leaf], np.float64)[:, steps // 2:].mean(1) for s in (js, ts)]
        se = np.sqrt(sum(d.var(ddof=1) / k for d in draws))
        assert abs(draws[0].mean() - draws[1].mean()) <= 4 * se, (leaf, draws, se)


def test_entry_points_without_card_raise(monkeypatch):
    """device=None means the card; without one the stochvol entry points
    raise instead of running on the CPU."""
    from repro_torch.core import init_cycle_samplers, run_cycle_sequential

    cpu = stochvol.synth(0, num_series=4, length=5, device="cpu")
    cyc = stochvol.make_inference_cycle(cpu.obs, batch_size=5, num_particles=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: stochvol.synth(0, num_series=4, length=5),
                 lambda: stochvol.make_joint_param_target(4, 5),
                 lambda: stochvol.run_posterior_sequential(0, cpu, 2),
                 lambda: stochvol.run_posterior_ensemble(0, cpu, num_chains=2, num_steps=8),
                 lambda: init_cycle_samplers(cyc),
                 lambda: run_cycle_sequential(0, stochvol.init_theta(cpu.obs), cyc, 1),
                 lambda: ChainEnsemble(num_chains=2, transition=cyc),
                 lambda: convert.sv_data(np.zeros((2, 3)), np.zeros((2, 3)))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_convert_round_trip():
    data = jsv.synth(jax.random.key(0), num_series=6, length=4)
    tdata = convert.sv_data(np.asarray(data.obs), np.asarray(data.h_true), device="cpu")
    np.testing.assert_array_equal(tdata.obs.numpy(), np.asarray(data.obs))
    np.testing.assert_array_equal(tdata.h_true.numpy(), np.asarray(data.h_true))
    k = 3
    theta = {"phi": np.full(k, 0.9, np.float32), "sigma2": np.full(k, 0.01, np.float32),
             "h": np.zeros((k, 6, 4), np.float32)}
    th = convert.sv_theta(theta, device="cpu")
    assert th["h"].shape == (k, 6, 4) and th["phi"].dtype == torch.float32
    cyc = jsv.make_inference_cycle(data.obs, batch_size=5, num_particles=4)
    from repro.core.composite import init_cycle_samplers

    jstates = jax.tree.map(np.asarray, jax.vmap(lambda _: init_cycle_samplers(cyc))(
        jnp.arange(k)))
    states = convert.cycle_samplers(jstates, device="cpu")
    assert states[0].shape == (k,)
    for st, js in zip(states[1:], jstates[1:]):
        np.testing.assert_array_equal(st.idx.numpy(), js.idx)
        np.testing.assert_array_equal(st.pos.numpy(), js.pos)
        np.testing.assert_array_equal(st.size.numpy(), js.size)
    ens = ChainEnsemble(num_chains=k, device="cpu", transition=stochvol.make_inference_cycle(
        tdata.obs, batch_size=5, num_particles=4))
    from repro_torch.core import EnsembleState

    _, samples, _ = ens.run(0, EnsembleState(th, states), 3)
    assert samples["phi"].shape == (k, 3)
