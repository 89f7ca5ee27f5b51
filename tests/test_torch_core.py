"""The port's core modules (Alg. 1-3) against the JAX package.

Inputs are made with numpy from a seed. With the ``stream`` sampler a
sequential test draws no randomness, so given the reference's theta, theta'
and log u, both packages must reach the same decision after the same
rounds. State crosses over through :mod:`repro_torch.convert`.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

import repro.core as J
from repro.core import samplers as jsamplers
from repro.core import stats as jstats
from repro.core.ensemble import _make_batched_transition
from repro_torch import convert
from repro_torch.core import (
    ChainEnsemble,
    RandomWalk,
    SubsampledMHConfig,
    Welford,
    build_target,
    exact_decide,
    finish_transition,
    fy_draw,
    fy_init,
    make_sampler,
    run_chain,
    sequential_test,
    student_t_sf,
)
from repro_torch.core.samplers import sampler_fns, stream_init
from repro_torch.kernels import ref
from repro_torch.kernels.fy_draw import fy_draw_ref

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)
N, D = 600, 5
PRIOR_VAR = 0.1


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def lr():
    """One small BayesLR problem in both packages (data made with numpy)."""
    rng = np.random.default_rng(0)
    scales = 1.0 / np.sqrt(1.0 + np.arange(D))
    x = (rng.standard_normal((N, D)) * scales).astype(np.float32)
    w_true = (2.0 * rng.standard_normal(D) * scales).astype(np.float32)
    y = np.where(rng.uniform(size=N) < 1 / (1 + np.exp(-x @ w_true)), 1.0, -1.0).astype(np.float32)
    jt = J.build_target("logit", (jnp.asarray(x), jnp.asarray(y)), N,
                        prior_logpdf=lambda w: (-0.5 / PRIOR_VAR) * jnp.sum(w ** 2))
    data = convert.lr_data(x, y, device="cpu")
    tt = build_target("logit", (data.x_train, data.y_train), N,
                      prior_logpdf=lambda w: (-0.5 / PRIOR_VAR) * (w ** 2).sum(-1))
    return {"x": x, "y": y, "w_true": w_true, "jt": jt, "tt": tt}


# ---------------------------------------------------------------------------
# Alg. 2 statistics
# ---------------------------------------------------------------------------


def test_welford_masked_merge_matches_jax():
    rng = np.random.default_rng(1)
    jw, tw = jstats.Welford.empty(), Welford.empty(device="cpu")
    for i in range(6):
        v = rng.standard_normal(40).astype(np.float32) * (i + 1)
        mask = rng.uniform(size=40) < 0.7
        if i == 2:
            mask[:] = False  # an empty batch keeps the state
        if i == 4:
            mask = None
        jw = jw.merge_batch(jnp.asarray(v), None if mask is None else jnp.asarray(mask))
        tw = tw.merge_batch(_t(v), None if mask is None else _t(mask))
        assert float(tw.count) == float(jw.count)
        np.testing.assert_allclose(float(tw.mean), float(jw.mean), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(tw.m2), float(jw.m2), rtol=1e-6)
        np.testing.assert_allclose(float(tw.std), float(jw.std), rtol=1e-6)


T_GRID = np.linspace(0.0, 8.0, 33).astype(np.float32)


@pytest.mark.parametrize("df", [1, 2, 5, 10, 30, 100, 300])
def test_student_t_sf_matches_jax(df):
    """The same float32 recurrence: 1e-5 relative where lgamma(df/2) is
    small enough that an ulp of XLA's log against PyTorch's cannot reach
    1e-5 (df <= 300)."""
    want = np.array([float(jstats.student_t_sf(t, np.float32(df))) for t in T_GRID])
    got = student_t_sf(_t(T_GRID), torch.full((T_GRID.size,), float(df))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("df", [1_000, 10_000, 30_000, 100_000])
def test_student_t_sf_large_df(df):
    """At large df the reference's tail is set by float32 rounding in its
    lgamma prefactor (lgamma(df/2) ~ 5e5 at df = 1e5, where one ulp is
    0.03). The port holds the recurrence to 2e-4 relative when both use
    XLA's own lgamma, and its lgamma to XLA's within 8 ulps."""
    ts = torch.from_numpy(T_GRID)
    dfs = torch.full_like(ts, float(df))
    xla_lgamma = lambda v: torch.from_numpy(np.asarray(jax.lax.lgamma(jnp.asarray(v.numpy()))).copy())
    want = np.array([float(jstats.student_t_sf(t, np.float32(df))) for t in T_GRID])
    got = ref.student_t_sf_ref(ts, dfs, lgamma=xla_lgamma).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-30)
    a = np.arange(1, 4001, dtype=np.float32) * np.float32(df / 4000.0) + np.float32(0.5)
    mine = ref.lgamma_fp32(_t(a)).numpy().astype(np.float64)
    xla = np.asarray(jax.lax.lgamma(jnp.asarray(a))).astype(np.float64)
    ulp = np.spacing(np.abs(gammaln(a.astype(np.float64))).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(mine - xla) <= 8 * ulp + 1e-6)


def test_sequential_test_doctest_case():
    state0, reset, draw = make_sampler("stream", 1000, device="cpu")
    res = sequential_test(None, torch.tensor(-1.0), draw, lambda idx: idx.float(), reset(state0),
                          1000, 50, 0.05)
    assert (bool(res.decision), int(res.rounds), int(res.n_evaluated)) == (True, 1, 50)
    # exhausting the pool decides exactly
    res = sequential_test(None, torch.tensor(0.0), draw, lambda idx: torch.zeros(idx.shape),
                          reset(state0), 1000, 300, 0.05)
    assert int(res.n_evaluated) == 1000 and int(res.rounds) == 4 and not bool(res.decision)


def test_fisher_yates_draws_without_replacement():
    gen = torch.Generator().manual_seed(0)
    n, m = 50, 16
    state = fy_init(n, device="cpu")
    seen = []
    for _ in range(4):
        state, idx, valid = fy_draw(gen, state, m)
        seen.append(idx[valid])
    allidx = torch.cat(seen)
    assert allidx.numel() == n and torch.equal(allidx.sort().values, torch.arange(n, dtype=torch.int32))
    state, idx, valid = fy_draw(gen, state, m)  # pool exhausted: nothing valid
    assert not bool(valid.any()) and int(state.pos) == n
    # the first draw after a reset is uniform over the pool
    counts = np.zeros(n)
    reset, draw = sampler_fns("fy")
    for _ in range(400):
        state, idx, _ = draw(gen, reset(state), 5)
        counts[idx.numpy()] += 1
    expected = 400 * 5 / n
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < 100  # chi-square, 49 dof: p ~ 3e-5 at 100


# (capacity, size, pos, m, rounds): `rounds` draws in a row from a permuted
# buffer, the state carried from one draw to the next
_FY_JAX_CASES = {
    "fresh_pool": (1000, 1000, 0, 100, 1),
    "rounds_to_exhaustion": (300, 257, 0, 100, 4),
    "pos_plus_m_past_capacity": (1000, 1000, 950, 100, 1),
    "exhausted_pool": (50, 50, 50, 10, 1),
    "size_below_capacity": (64, 40, 30, 20, 1),
    "m_above_size": (16, 9, 0, 30, 1),
}


@pytest.mark.parametrize("case", list(_FY_JAX_CASES))
def test_plain_fisher_yates_draw_matches_jax(case):
    """The plain draw against ``repro.core.samplers.fy_draw``, exactly. The
    reference's swap draws are r_s = randint(keys[s], 0, span_s) with keys =
    split(key, m); the port's uniform u_s = (r_s + 0.5) / span_s (float64)
    truncates back to r_s, so indices, valid flags, positions and buffers
    must be identical. Each case also reports which edge cases its draws
    hit: several steps on one target, a target inside the window ahead of
    its step, self-swaps of the clamped or exhausted tail."""
    cap, size, pos, m, rounds = _FY_JAX_CASES[case]
    seed = list(_FY_JAX_CASES).index(case)
    buf = np.random.default_rng(seed).permutation(cap).astype(np.int32)
    jstate = jsamplers.fy_from_buffer(jnp.asarray(buf), size)._replace(
        pos=jnp.asarray(pos, jnp.int32))
    tbuf = torch.tensor(buf)[None].clone()
    tpos, tsize = (torch.tensor([v], dtype=torch.int32) for v in (pos, size))
    randint = jax.vmap(lambda k, span: jax.random.randint(k, (), 0, span, dtype=jnp.int32))
    hits = set()
    for r in range(rounds):
        key = jax.random.fold_in(jax.random.key(seed), r)
        p = np.minimum(int(jstate.pos) + np.arange(m), cap - 1)
        span = np.maximum(size - p, 1).astype(np.int32)
        draws = np.asarray(randint(jax.random.split(key, m), jnp.asarray(span)))
        u = (draws.astype(np.float64) + 0.5) / span
        assert np.array_equal(np.minimum((u * span).astype(np.int32), span - 1), draws)
        j = np.minimum(p + draws, cap - 1)
        moved = j[j != p]
        if len(np.unique(moved)) < len(moved):
            hits.add("duplicate targets")
        if np.any((j > p) & (j < int(jstate.pos) + m)):
            hits.add("target in the window ahead")
        if np.any(j == p):
            hits.add("self-swaps")

        jstate, jout, jvalid = jsamplers.fy_draw(key, jstate, m)
        out, valid, new_pos = fy_draw_ref(torch.tensor(u)[None], tbuf, tpos, tsize, m)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout))
        np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jvalid))
        assert int(new_pos[0]) == int(jstate.pos)
        np.testing.assert_array_equal(tbuf[0].numpy(), np.asarray(jstate.idx))
        tpos = new_pos
    expected = {"fresh_pool": {"duplicate targets", "target in the window ahead"},
                "rounds_to_exhaustion": {"duplicate targets", "self-swaps"},
                "pos_plus_m_past_capacity": {"self-swaps"},
                "exhausted_pool": {"self-swaps"},
                "size_below_capacity": {"self-swaps"},
                "m_above_size": {"duplicate targets", "self-swaps"}}[case]
    assert expected <= hits, f"{case} hit only {sorted(hits)}"


# ---------------------------------------------------------------------------
# Alg. 3 on 200 fixed (theta, theta', log u) triples
# ---------------------------------------------------------------------------


def _triples(n_keys, seed=3):
    rng = np.random.default_rng(seed)
    theta = (0.3 * rng.standard_normal((n_keys, D))).astype(np.float32)
    keys = jax.random.split(jax.random.key(seed), n_keys)
    return theta, keys


CFG = dict(batch_size=50, epsilon=0.05, sampler="stream")


def _agree(a, b, what, frac=0.99):
    agree = float(np.mean(np.asarray(a) == np.asarray(b)))
    assert agree >= frac, f"{what}: only {agree:.3f} agree"
    return np.asarray(a) == np.asarray(b)


def test_single_chain_step_matches_jax(lr):
    theta, keys = _triples(200)
    jcfg = J.SubsampledMHConfig(**CFG)
    rw = J.RandomWalk(0.05)
    state0, step = J.make_kernel(lr["jt"], rw, jcfg)

    def one(args):
        k, th = args
        th_p, _, log_u, _ = J.propose_and_mu0(k, th, lr["jt"], rw)
        _, _, info = step(k, th, state0)
        return th_p, log_u, info

    th_p, log_u, info = jax.jit(lambda ks, th: jax.lax.map(one, (ks, th)))(keys, jnp.asarray(theta))
    th_p, log_u = np.asarray(th_p), np.asarray(log_u)
    cfg = SubsampledMHConfig(**CFG)
    reset_fn, draw_fn = sampler_fns("stream")
    got = {k: [] for k in ("mu0", "rounds", "n_evaluated", "accepted", "mu_hat")}
    for i in range(200):
        th, thp, lu = _t(theta[i]), _t(th_p[i]), torch.tensor(log_u[i])
        mu0 = (lu - lr["tt"].log_global(th, thp)) / N
        _, _, tinfo = finish_transition(None, th, thp, mu0, lu, stream_init(N, device="cpu"),
                                        lr["tt"], cfg, reset_fn, draw_fn)
        for k in got:
            got[k].append(float(getattr(tinfo, k)))
    np.testing.assert_allclose(got["mu0"], np.asarray(info.mu0), rtol=1e-5, atol=1e-7)
    same = _agree(got["rounds"], info.rounds, "rounds")
    _agree(got["n_evaluated"], info.n_evaluated, "n_evaluated")
    _agree(got["accepted"], info.accepted, "decision")
    np.testing.assert_allclose(np.asarray(got["mu_hat"])[same], np.asarray(info.mu_hat)[same],
                               rtol=1e-5, atol=1e-5)


def test_exact_mh_step_matches_jax(lr):
    theta, keys = _triples(200, seed=4)
    rw = J.RandomWalk(0.05)

    def one(args):
        k, th = args
        _, k_prop = jax.random.split(k)
        th_p, _ = rw(k_prop, th)
        _, info = J.mh_step(k, th, lr["jt"], rw, chunk_size=256)
        return th_p, info

    th_p, info = jax.jit(lambda ks, th: jax.lax.map(one, (ks, th)))(keys, jnp.asarray(theta))
    th_p = np.asarray(th_p)
    acc, mu_hat = [], []
    for i in range(200):
        th, thp = _t(theta[i]), _t(th_p[i])
        lu = torch.tensor(np.asarray(info.log_u)[i])
        g = lr["tt"].log_global(th, thp)
        _, tinfo = exact_decide(th, thp, g, lu, lr["tt"], chunk_size=256)
        acc.append(bool(tinfo.accepted))
        mu_hat.append(float(tinfo.mu_hat))
    _agree(acc, info.accepted, "exact decision")
    np.testing.assert_allclose(mu_hat, np.asarray(info.mu_hat), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk_size", [None, 256, 77])
def test_exact_decide_range_form_matches_index_tensor(lr, chunk_size):
    """The logit family scores the full pass's chunks as ``range``s (no
    index tensor); a target without that form gets the index tensors the
    reference's ``arange`` chunks are. Whole and chunked, both reach the
    same decision, mu_hat and n_evaluated."""
    tt = lr["tt"]
    assert tt.range_sections
    # the same log_local behind a target built by hand, which gets tensors
    by_index = build_target(None, None, N, log_global=tt.log_global, log_local=tt.log_local)
    assert not by_index.range_sections
    rng = np.random.default_rng(9)
    for _ in range(20):
        th = _t((0.5 * rng.standard_normal(D)).astype(np.float32))
        thp = th + _t((0.05 * rng.standard_normal(D)).astype(np.float32))
        lu = torch.tensor(np.log(rng.uniform()), dtype=torch.float32)
        g = tt.log_global(th, thp)
        (a, ia), (b, ib) = (exact_decide(th, thp, g, lu, t, chunk_size=chunk_size)
                            for t in (tt, by_index))
        assert torch.equal(a, b) and bool(ia.accepted) == bool(ib.accepted)
        assert torch.equal(ia.mu_hat, ib.mu_hat) and int(ia.n_evaluated) == int(ib.n_evaluated) == N
        assert int(ia.rounds) == int(ib.rounds)


def test_lockstep_round_matches_jax(lr):
    """A K=4 lock-step ensemble, 50 transitions from the same state: each
    transition's proposals come from the reference, the rounds run in both."""
    k, steps = 4, 50
    rng = np.random.default_rng(5)
    jcfg = J.SubsampledMHConfig(**CFG)
    rw = J.RandomWalk(0.05)
    max_rounds = -(-N // CFG["batch_size"])
    trans = jax.jit(_make_batched_transition(lr["jt"], rw, jcfg, k, False, max_rounds=max_rounds))
    cfg = SubsampledMHConfig(**CFG)
    reset_fn, draw_fn = sampler_fns("stream")
    got, want = {n: [] for n in ("accepted", "rounds", "n_evaluated", "mu_hat")}, []
    jtheta = jnp.asarray((0.3 * rng.standard_normal((k, D))).astype(np.float32))
    jsampler = jax.vmap(lambda _: J.stream_init(N))(jnp.arange(k))
    eps, meff = jnp.full((k,), CFG["epsilon"]), jnp.full((k,), CFG["batch_size"], jnp.int32)
    for t in range(steps):
        keys = jax.random.split(jax.random.key(100 + t), k)
        th_p, mu0, log_u, _ = jax.vmap(lambda kk, th: J.propose_and_mu0(kk, th, lr["jt"], rw))(
            keys, jtheta)
        state = convert.ensemble_state(np.asarray(jtheta), "stream", N,
                                       pos=np.asarray(jsampler.pos), device="cpu")
        theta, thp = state.theta, _t(np.asarray(th_p))
        lu = _t(np.asarray(log_u))
        tmu0 = (lu - lr["tt"].log_global(theta, thp)) / N
        np.testing.assert_allclose(tmu0.numpy(), np.asarray(mu0), rtol=1e-5, atol=1e-7)
        _, _, tinfo = finish_transition(None, theta, thp, tmu0, lu, state.sampler_state,
                                        lr["tt"], cfg, reset_fn, draw_fn,
                                        max_rounds=max_rounds,
                                        eval_fn=lr["tt"].local_round(theta, thp, ensemble=True))
        jtheta, jsampler, jinfo = trans(keys, jtheta, jsampler, eps, meff)
        want.append(jinfo)
        for n in got:
            got[n].append(getattr(tinfo, n).numpy())
    for n in ("accepted", "rounds", "n_evaluated"):
        _agree(np.concatenate(got[n]), np.concatenate([np.asarray(getattr(w, n)) for w in want]), n)
    np.testing.assert_allclose(np.concatenate(got["mu_hat"]),
                               np.concatenate([np.asarray(w.mu_hat) for w in want]),
                               rtol=1e-5, atol=1e-5)


def test_ensemble_of_one_equals_run_chain(lr):
    for sampler in ("stream", "fy"):
        cfg = SubsampledMHConfig(batch_size=50, epsilon=0.05, sampler=sampler)
        th, samples, infos = run_chain(7, torch.zeros(D), lr["tt"], RandomWalk(0.05), 15,
                                       config=cfg, device="cpu")
        ens = ChainEnsemble(lr["tt"], RandomWalk(0.05), 1, config=cfg, device="cpu")
        state, esamples, einfos = ens.run(7, ens.init(torch.zeros(D)), 15)
        assert torch.equal(esamples[0], samples)
        assert torch.equal(einfos.n_evaluated[0], infos.n_evaluated)
        assert torch.equal(einfos.accepted[0], infos.accepted)


def test_fused_and_plain_routes_agree_on_cpu(lr):
    cfg = SubsampledMHConfig(batch_size=50, epsilon=0.05, sampler="stream")
    out = []
    for route in ("auto", "never"):
        ens = ChainEnsemble(lr["tt"], RandomWalk(0.05), 3, config=cfg, fused_kernels=route,
                            device="cpu")
        out.append(ens.run(1, ens.init(torch.zeros(D)), 10))
    assert torch.equal(out[0][1], out[1][1])
    with pytest.raises(RuntimeError, match="CUDA"):
        ens = ChainEnsemble(lr["tt"], RandomWalk(0.05), 3, config=cfg, fused_kernels="always",
                            device="cpu")
        ens.run(1, ens.init(torch.zeros(D)), 1)


def test_deferred_paths_raise(lr):
    """The mesh paths are ported (tests/test_torch_distributed.py): on one
    slot every shard= form runs unsharded, bit for bit the default run.
    Masked stepping and schedules are ported (tests/test_torch_schedule.py),
    and a schedule that is not a ScheduleConfig is refused. Per-chain
    (K, N, D) logit pools are ported: an ensemble round equals the
    reference's (tests/test_torch_perchain.py holds them further)."""
    cfg = SubsampledMHConfig(batch_size=50, epsilon=0.05)
    base = ChainEnsemble(lr["tt"], RandomWalk(0.05), 2, config=cfg, device="cpu")
    _, want, _ = base.run(1, base.init(torch.zeros(D)), 5)
    for kw in (dict(shard=True), dict(shard=("chains", "data"))):
        ens = ChainEnsemble(lr["tt"], RandomWalk(0.05), 2, config=cfg, device="cpu", **kw)
        assert ens._mesh is None
        assert torch.equal(ens.run(1, ens.init(torch.zeros(D)), 5)[1], want)
    with pytest.raises(TypeError):
        ChainEnsemble(lr["tt"], RandomWalk(0.05), 2, device="cpu", schedule=object())
    # composite cycles are ported; a cycle beside (target, proposal) is refused
    with pytest.raises((TypeError, ValueError)):
        ChainEnsemble(lr["tt"], RandomWalk(0.05), 2, device="cpu", transition=object())
    # per-chain (K, N, D) logit pools: the reference's round on the same pools
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((2, 10, 3)).astype(np.float32)
    ys = np.where(rng.uniform(size=(2, 10)) < 0.5, 1.0, -1.0).astype(np.float32)
    w, wp = rng.standard_normal((2, 2, 3)).astype(np.float32)
    idx = rng.integers(0, 10, (2, 4)).astype(np.int32)
    per_chain = build_target("logit", (_t(xs), _t(ys)), 10, prior_logpdf=lambda t: t.sum(-1))
    j_chain = J.build_target("logit", (jnp.asarray(xs), jnp.asarray(ys)), 10,
                             prior_logpdf=lambda t: t.sum(-1))
    got = per_chain.log_local_ensemble(_t(w), _t(wp), _t(idx)).numpy()
    want = np.asarray(j_chain.log_local_ensemble(jnp.asarray(w), jnp.asarray(wp),
                                                 jnp.asarray(idx)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)



_DIAGNOSTICS = ["split_rhat_KT", "split_rhat_KTP", "multichain_ess", "effective_sample_size",
                "autocorrelation", "tail_latency_summary"]


@pytest.mark.parametrize("name", _DIAGNOSTICS)
def test_chain_diagnostics_match_jax(name):
    """The ported chain diagnostics equal the reference's exactly on
    numpy-seeded chains (AR(1) traces with mixed means, so R-hat, the
    autocorrelation and Geyer's ESS are all away from their trivial values;
    integer round counts with a long tail)."""
    from repro_torch.core import stats

    rng = np.random.default_rng(_DIAGNOSTICS.index(name))
    k, t = 6, 401
    x = np.zeros((k, t, 3))
    for i in range(1, t):
        x[:, i] = 0.8 * x[:, i - 1] + rng.standard_normal((k, 3))
    x += rng.normal(0, 0.5, (k, 1, 3))
    rounds = rng.geometric(0.35, (k, 50))
    got, want = {
        "split_rhat_KT": lambda m: m.split_rhat(x[..., 0]),
        "split_rhat_KTP": lambda m: m.split_rhat(x.astype(np.float32)),
        "multichain_ess": lambda m: m.multichain_ess(x[..., 1]),
        "effective_sample_size": lambda m: m.effective_sample_size(x[2, :, 2]),
        "autocorrelation": lambda m: m.autocorrelation(x[0, :, 0], max_lag=60),
        "tail_latency_summary": lambda m: m.tail_latency_summary(rounds),
    }[name](stats), None
    want = {"split_rhat_KT": jstats.split_rhat(x[..., 0]),
            "split_rhat_KTP": jstats.split_rhat(x.astype(np.float32)),
            "multichain_ess": jstats.multichain_ess(x[..., 1]),
            "effective_sample_size": jstats.effective_sample_size(x[2, :, 2]),
            "autocorrelation": jstats.autocorrelation(x[0, :, 0], max_lag=60),
            "tail_latency_summary": jstats.tail_latency_summary(rounds)}[name]
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    else:
        np.testing.assert_array_equal(got, want)
    if name.startswith("split_rhat"):
        assert np.min(got) > 1.01  # the chains' offsets show


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_card_raise(lr, no_card):
    from repro_torch.experiments import bayeslr

    with pytest.raises(RuntimeError, match="CUDA"):
        bayeslr.synth_mnist_like(0, n_train=10, n_test=2, d=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        bayeslr.synth_2d(0, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        ChainEnsemble(lr["tt"], RandomWalk(0.05), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_chain(0, torch.zeros(D), lr["tt"], RandomWalk(0.05), 1)
    data = convert.lr_data(lr["x"], lr["y"], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        bayeslr.run_posterior_ensemble(0, data, num_chains=2, num_steps=2)
    assert bayeslr.synth_2d(0, 10, device="cpu").x_train.device.type == "cpu"


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.core, repro_torch.experiments.bayeslr\n"
        "import repro_torch.experiments.stochvol, repro_torch.inference.smc\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build, repro_torch.kernels.pgibbs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == ""
