"""The port's adaptive scheduler, bounded draws and masked stepping against
the JAX package (``repro.core.schedule``, ``samplers``, ``ensemble``).

Inputs are made with numpy from a seed. The controller is deterministic, so
it is held bit for bit on the same infos; the bounded draws are held exactly
given the reference's own swap draws; masked stepping is held bit for bit
against the port's lock-step stepping with the stream sampler, and by
distribution against the reference's masked run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import samplers as jsamplers
from repro.core import schedule as jschedule
from repro_torch.core import (
    MALA,
    ChainEnsemble,
    IndependentGaussian,
    RandomWalk,
    ScheduleConfig,
    SubsampledMHConfig,
    SubsampledMHInfo,
    SubsampledMHOp,
    build_target,
    controller_init,
    controller_params,
    controller_update,
    cycle,
    from_iid_loglik,
    make_kernel,
    run_chain,
    split_rhat,
    stream_draw_bounded,
    stream_init,
)
from repro_torch.kernels.fy_draw import fy_draw_ref

torch.set_num_threads(1)
CFG = SubsampledMHConfig(batch_size=50, epsilon=0.05)
N, D = 600, 5


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

_FLAGS = {  # ScheduleConfig keyword sets: each adapt flag on and off
    "defaults": {},
    "all_off": dict(adapt_batch_size=False, adapt_epsilon=False),
    "batch_only": dict(adapt_epsilon=False),
    "epsilon_only": dict(adapt_batch_size=False),
    "proposal_constant_gain": dict(adapt_proposal=True),
    "proposal_gain_decay_0.75": dict(adapt_proposal=True, adapt_gain_decay=0.75),
}


@pytest.mark.parametrize("flags", list(_FLAGS))
def test_controller_matches_jax_bit_for_bit(flags):
    """50 transitions of 6 chains from one numpy-seeded sequence of infos
    (rounds 1..12, n_evaluated over the whole pool, acceptance 0/1): the
    buckets, epsilons, EMAs, counts, sigma scales and knobs equal the
    reference's op-by-op controller bit for bit at every step.

    One known exception lies beyond these 50 steps: with
    ``adapt_gain_decay`` the port raises (1 + t) to the decay as a float64
    ``pow`` rounded to float32, which differs from the float32 ``powf`` of
    XLA's CPU backend by one ulp at about 0.07% of integers t, the first at
    t = 323 for a decay of 0.75; the sigma scale can then differ by an ulp.
    Everything else (the exp of the scale update included, which the port
    computes as XLA's CPU code does) is bit for bit at every t."""
    n, k = 1000, 6
    sched_j = jschedule.ScheduleConfig(epsilon_max=0.2, **_FLAGS[flags])
    sched_t = ScheduleConfig(epsilon_max=0.2, **_FLAGS[flags])
    buckets = sched_t.buckets_for(CFG, n)
    assert buckets == sched_j.buckets_for(CFG, n)
    floor = sched_t.epsilon_floor(CFG)
    js = jschedule.controller_init(sched_j, CFG, n, num_chains=k)
    ts = controller_init(sched_t, CFG, n, k, device="cpu")
    rng = np.random.default_rng(list(_FLAGS).index(flags))
    for step in range(50):
        rounds = rng.integers(1, 13, k).astype(np.int32)
        n_eval = np.minimum(rounds * rng.integers(20, 110, k), n).astype(np.int32)
        accepted = rng.uniform(size=k) < 0.3
        jinfo = J.SubsampledMHInfo(*(jnp.zeros(k) for _ in range(9)))._replace(
            rounds=jnp.asarray(rounds), n_evaluated=jnp.asarray(n_eval),
            accepted=jnp.asarray(accepted))
        tinfo = SubsampledMHInfo(*(torch.zeros(k) for _ in range(9)))._replace(
            rounds=torch.from_numpy(rounds), n_evaluated=torch.from_numpy(n_eval),
            accepted=torch.from_numpy(accepted))
        js = jschedule.controller_update(js, jinfo, sched_j, buckets, n, floor)
        ts = controller_update(ts, tinfo, sched_t, buckets, n, floor)
        for name in J.ControllerState._fields:
            want, got = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), (step, name)
        for want, got in zip(jschedule.controller_params(js, buckets),
                             controller_params(ts, buckets)):
            assert np.array_equal(got.numpy(), np.asarray(want))
    moved = {"defaults": ("bucket", "epsilon"), "batch_only": ("bucket",),
             "epsilon_only": ("epsilon",), "proposal_constant_gain": ("sigma_scale",),
             "proposal_gain_decay_0.75": ("sigma_scale",)}.get(flags, ())
    init = controller_init(sched_t, CFG, n, k, device="cpu")
    for name in moved:  # the sequence exercises what the flags let move
        assert not torch.equal(getattr(ts, name), getattr(init, name)), name


def test_schedule_config_validation_and_buckets():
    for kw in (dict(batch_buckets=(0, 10)), dict(epsilon_grow=0.5), dict(epsilon_decay=0.0),
               dict(scale_min=2.0), dict(accept_target=1.0), dict(adapt_gain_decay=1.5)):
        with pytest.raises(ValueError):
            ScheduleConfig(**kw)
        with pytest.raises(ValueError):
            jschedule.ScheduleConfig(**kw)
    for kw, n in ((dict(batch_buckets=(100, 25, 100, 50)), 60), ({}, 5000), ({}, 120),
                  (dict(epsilon_min=0.01, epsilon_max=0.02), None)):
        t, j = ScheduleConfig(**kw), jschedule.ScheduleConfig(**kw)
        assert t.batch_buckets == j.batch_buckets
        for cfg in (CFG, SubsampledMHConfig(batch_size=1), SubsampledMHConfig(batch_size=100)):
            assert t.buckets_for(cfg, n) == j.buckets_for(cfg, n)
            assert t.epsilon_floor(cfg) == j.epsilon_floor(cfg)
    assert ScheduleConfig(batch_buckets=(100, 25, 100, 50)).buckets_for(CFG, 60) == (25, 50, 60)


# ---------------------------------------------------------------------------
# Bounded draws
# ---------------------------------------------------------------------------


def test_stream_draw_bounded_matches_jax():
    """Per-chain m_eff (0, 1, 7, m_max and past it), clamped at m_max, with
    inactive chains keeping their position; rounds until the pool runs out."""
    n, m_max = 100, 32
    meffs = np.array([0, 1, 7, 32, 99], np.int32)
    active = np.array([True, True, False, True, True])
    jstates = [jsamplers.stream_init(n) for _ in meffs]
    tstate = stream_init(n, device="cpu")._replace(pos=torch.zeros(len(meffs), dtype=torch.int32))
    for _ in range(5):
        tstate, idx, valid = stream_draw_bounded(None, tstate, m_max, torch.from_numpy(meffs),
                                                 torch.from_numpy(active))
        for c, me in enumerate(meffs):
            s, jidx, jvalid = jsamplers.stream_draw_bounded(jax.random.key(0), jstates[c], m_max,
                                                            jnp.int32(me))
            np.testing.assert_array_equal(idx[c].numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(valid[c].numpy(), np.asarray(jvalid))
            if active[c]:
                jstates[c] = s
            assert int(tstate.pos[c]) == int(jstates[c].pos)
    assert int(tstate.pos[3]) == n and int(tstate.pos[0]) == 0 and int(tstate.pos[2]) == 0


_FYB_CASES = {  # name: (capacity = size, m_max, per-round m_eff, rounds)
    "ragged_until_exhausted": (300, 64, (0, 64, 17, 50, 64, 40, 64, 64, 64), 9),
    "m_eff_above_m_max_clamped": (200, 40, (80, 3, 40, 40, 40, 40), 6),
    "m_max_past_capacity": (100, 128, (30, 128, 5), 3),
}


@pytest.mark.parametrize("case", list(_FYB_CASES))
def test_plain_fisher_yates_bounded_draw_matches_jax(case):
    """The plain draw with an m_eff against ``repro.core.samplers
    .fy_draw_bounded``, exactly, given the reference's own swap draws (as in
    test_torch_core.py::test_plain_fisher_yates_draw_matches_jax): the
    same indices, valid flags, positions and buffer after every round, and
    the valid lanes of one transition never repeat an index."""
    cap, m, meffs, rounds = _FYB_CASES[case]
    seed = list(_FYB_CASES).index(case)
    buf = np.random.default_rng(seed).permutation(cap).astype(np.int32)
    jstate = jsamplers.fy_from_buffer(jnp.asarray(buf), cap)
    tbuf = torch.tensor(buf)[None].clone()
    tpos, tsize = torch.zeros(1, dtype=torch.int32), torch.tensor([cap], dtype=torch.int32)
    randint = jax.vmap(lambda k, span: jax.random.randint(k, (), 0, span, dtype=jnp.int32))
    seen = []
    for r in range(rounds):
        key = jax.random.fold_in(jax.random.key(seed), r)
        p = np.minimum(int(jstate.pos) + np.arange(m), cap - 1)
        span = np.maximum(cap - p, 1).astype(np.int32)
        draws = np.asarray(randint(jax.random.split(key, m), jnp.asarray(span)))
        u = (draws.astype(np.float64) + 0.5) / span
        jstate, jout, jvalid = jsamplers.fy_draw_bounded(key, jstate, m, jnp.int32(meffs[r]))
        meff = torch.tensor([min(meffs[r], m)], dtype=torch.int32)
        out, valid, tpos = fy_draw_ref(torch.tensor(u)[None], tbuf, tpos, tsize, m, None, meff)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout))
        np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jvalid))
        assert int(tpos[0]) == int(jstate.pos)
        np.testing.assert_array_equal(tbuf[0].numpy(), np.asarray(jstate.idx))
        seen += out[0][valid[0]].tolist()
    assert len(seen) == len(set(seen)) and int(tpos[0]) <= cap
    if case == "ragged_until_exhausted":
        assert sorted(seen) == list(range(cap))


# ---------------------------------------------------------------------------
# Masked stepping and the scheduled ensemble
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lr_target():
    rng = np.random.default_rng(0)
    scales = 1.0 / np.sqrt(1.0 + np.arange(D))
    x = (rng.standard_normal((N, D)) * scales).astype(np.float32)
    w_true = (2.0 * rng.standard_normal(D) * scales).astype(np.float32)
    y = np.where(rng.uniform(size=N) < 1 / (1 + np.exp(-x @ w_true)), 1.0, -1.0).astype(np.float32)
    return build_target("logit", (torch.from_numpy(x), torch.from_numpy(y)), N,
                        prior_logpdf=lambda w: -5.0 * (w ** 2).sum(-1))


def _run(target, stepping, sampler="stream", k=3, steps=30, schedule=None, seed=5,
         proposal=None, state=None, gen=None):
    cfg = SubsampledMHConfig(batch_size=50, epsilon=0.05, sampler=sampler)
    ens = ChainEnsemble(target, proposal or RandomWalk(0.05), k, config=cfg, stepping=stepping,
                        schedule=schedule, device="cpu")
    gen = gen or torch.Generator().manual_seed(seed)
    st, samples, infos = ens.run(gen, state or ens.init(torch.zeros(D)), steps)
    return st, samples, infos, gen


def _assert_same(a, b):
    assert torch.equal(a[1], b[1])
    for name, x, y in zip(SubsampledMHInfo._fields, a[2], b[2]):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    assert torch.equal(a[0].theta, b[0].theta) and torch.equal(a[3].get_state(), b[3].get_state())


@pytest.mark.parametrize("schedule", [None, ScheduleConfig(epsilon_max=0.2)],
                         ids=["no_schedule", "schedule"])
def test_masked_equals_lockstep_bit_for_bit_with_stream_sampler(lr_target, schedule):
    """With the stream sampler the rounds draw nothing, so each chain's step
    t draws from lock-step's generator state: samples, every info field, the
    final theta and the generator's end state are identical, in far fewer
    supersteps than lock-step rounds. With a schedule each chain's
    controller sees the same transitions in both modes, so that holds too."""
    lock = _run(lr_target, "lockstep", schedule=schedule)
    mask = _run(lr_target, "masked", schedule=schedule)
    _assert_same(lock, mask)
    rounds = mask[2].rounds
    assert int(rounds.sum(1).max()) < int(rounds.max(0).values.sum())
    if schedule is not None:
        for x, y in zip(lock[0].controller, mask[0].controller):
            assert torch.equal(x, y)


@pytest.mark.parametrize("sampler", ["stream", "fy"])
def test_masked_single_chain_equals_run_chain(lr_target, sampler):
    """K = 1: the superstep draws in the single chain's order, with either
    sampler."""
    cfg = SubsampledMHConfig(batch_size=50, epsilon=0.05, sampler=sampler)
    _, samples, infos, _ = _run(lr_target, "masked", sampler=sampler, k=1, steps=25, seed=7)
    _, s1, i1 = run_chain(7, torch.zeros(D), lr_target, RandomWalk(0.05), 25, config=cfg,
                          device="cpu")
    assert torch.equal(samples[0], s1)
    for name in ("accepted", "n_evaluated", "rounds", "mu_hat", "pvalue"):
        assert torch.equal(getattr(infos, name)[0], getattr(i1, name)), name


def test_second_run_continues_controller_and_sampler(lr_target):
    """Masked + schedule: 20 steps, then 10 more from the returned state and
    the same generator, equal one run of 30 (the controller, the sampler
    state and the generator all carry over); the Fisher–Yates run carries
    its controller count too."""
    sched = ScheduleConfig(epsilon_max=0.2)
    whole = _run(lr_target, "masked", schedule=sched)
    first = _run(lr_target, "masked", schedule=sched, steps=20)
    second = _run(lr_target, "masked", schedule=sched, steps=10, state=first[0], gen=first[3])
    assert torch.equal(whole[1], torch.cat([first[1], second[1]], 1))
    assert torch.equal(whole[2].batch_eff, torch.cat([first[2].batch_eff, second[2].batch_eff], 1))
    for x, y in zip(whole[0].controller, second[0].controller):
        assert torch.equal(x, y)
    fy = _run(lr_target, "masked", sampler="fy", schedule=sched, steps=10)
    fy2 = _run(lr_target, "masked", sampler="fy", schedule=sched, steps=5, state=fy[0],
               gen=fy[3])
    assert fy2[0].controller.t.tolist() == [15] * 3
    assert not torch.equal(fy2[0].sampler_state.idx, torch.arange(N, dtype=torch.int32)
                           .repeat(3, 1))


def test_lockstep_schedule_draws_buckets_above_base_batch(lr_target):
    """The round shape is the largest bucket: a single bucket of 200 is
    drawn in full from the first round (the reference's
    test_lockstep_schedule_realizes_buckets_above_base_batch), through the
    ensemble and through make_kernel(scheduled=True)."""
    sched = ScheduleConfig(batch_buckets=(200,))
    st, _, infos, _ = _run(lr_target, "lockstep", k=2, steps=10, schedule=sched)
    assert infos.batch_eff.min() == 200 and infos.n_evaluated.min() >= 200
    assert st.controller.t.tolist() == [10, 10]
    state0, step = make_kernel(lr_target, RandomWalk(0.05), CFG, scheduled=True, batch_max=200,
                               device="cpu")
    _, _, info = step(torch.Generator().manual_seed(0), torch.zeros(D), state0,
                      torch.tensor(0.05), torch.tensor(200, dtype=torch.int32), 3)
    assert int(info.batch_eff) == 200 and int(info.n_evaluated) >= 200 and int(info.rounds) <= 3


def _gaussian(n=600, seed=1):
    """The reference's gaussian_target_factory target, in the port."""
    x = 0.7 + np.asarray(jax.random.normal(jax.random.key(seed), (n,)))
    xt = torch.from_numpy(x.astype(np.float32))
    target = from_iid_loglik(lambda th: -0.5 * th ** 2, lambda th, idx: -0.5 * (xt[idx] - th) ** 2,
                             None, n)
    return target, float(x.sum() / (n + 1)), float(np.sqrt(1.0 / (n + 1)))


def test_masked_adaptive_gaussian_against_closed_form_and_reference(gaussian_target_factory):
    """Masked + schedule on the reference's conjugate Gaussian (n=600), K=4,
    300 steps, RW 0.08, the Fisher–Yates sampler: every epsilon within
    [floor, epsilon_max], every batch a bucket, 300 controller updates a
    chain; over the second half the posterior mean lies within 6 posterior
    sds of the closed form (the reference test's bound) and of the
    reference's own masked run, the variance within a factor 2.5 of the
    closed form's and the reference's (about 150 correlated draws a chain),
    and split R-hat below 1.2."""
    jtarget, pm, ps = gaussian_target_factory(n=600, seed=1)
    target, pm_t, _ = _gaussian()
    assert abs(pm - pm_t) < 1e-6
    sched = ScheduleConfig(epsilon_max=0.2)
    k, t = 4, 300
    ens = ChainEnsemble(target, RandomWalk(0.08), k, config=CFG, stepping="masked",
                        schedule=sched, device="cpu")
    state, samples, infos = ens.run(2, ens.init(torch.tensor(pm)), t)
    eps = infos.epsilon.numpy()
    assert eps.min() >= np.float32(CFG.epsilon) and eps.max() <= np.float32(0.2)
    assert set(np.unique(infos.batch_eff.numpy()).tolist()) <= set(sched.buckets_for(CFG, 600))
    assert state.controller.t.tolist() == [t] * k
    jens = J.ChainEnsemble(jtarget, J.RandomWalk(0.08), k, config=J.SubsampledMHConfig(
        batch_size=50, epsilon=0.05), stepping="masked", schedule=jschedule.ScheduleConfig(
        epsilon_max=0.2))
    _, jsamples, _ = jens.run(jax.random.key(2), jens.init(jnp.zeros(()) + pm), t)
    s, js = samples.numpy()[:, t // 2:], np.asarray(jsamples)[:, t // 2:]
    assert abs(s.mean() - pm) < 6 * ps and abs(s.mean() - js.mean()) < 6 * ps
    assert 1 / 2.5 < s.var() / ps ** 2 < 2.5 and 1 / 2.5 < s.var() / js.var() < 2.5
    assert split_rhat(s) < 1.2


def test_construction_rules_raise_as_the_reference(lr_target, gaussian_target_factory):
    jtarget, _, _ = gaussian_target_factory(n=600, seed=1)
    kw = dict(device="cpu")
    cases = [dict(kernel="exact", stepping="masked"), dict(kernel="exact", schedule=ScheduleConfig()),
             dict(stepping="masked", shard=True), dict(stepping="nope"),
             dict(fused_kernels="maybe")]
    for c in cases:
        with pytest.raises(ValueError):
            ChainEnsemble(lr_target, RandomWalk(0.05), 2, **kw, **c)
        jc = {k: (jschedule.ScheduleConfig() if k == "schedule" else v) for k, v in c.items()}
        with pytest.raises(ValueError):
            J.ChainEnsemble(jtarget, J.RandomWalk(0.05), 2, **jc)
    target, _, _ = _gaussian()
    with pytest.raises(ValueError):  # no log_local_ensemble to force
        ChainEnsemble(target, RandomWalk(0.05), 2, fused_kernels="always", **kw)
    prop_sched = ScheduleConfig(adapt_proposal=True)
    for proposal in (IndependentGaussian(torch.zeros(D)), MALA(0.01, lambda th: th)):
        with pytest.raises(ValueError, match="scale"):
            ChainEnsemble(lr_target, proposal, 2, schedule=prop_sched, **kw)
    with pytest.raises(ValueError, match="scale"):
        J.ChainEnsemble(jtarget, J.IndependentGaussian(jnp.zeros(())), 2,
                        schedule=jschedule.ScheduleConfig(adapt_proposal=True))
    ChainEnsemble(lr_target, RandomWalk(0.05), 2, schedule=prop_sched, **kw)
    op = SubsampledMHOp(lr_target, RandomWalk(0.05), CFG)
    for c in (dict(stepping="masked"), dict(schedule=ScheduleConfig())):
        with pytest.raises(ValueError):
            ChainEnsemble(num_chains=2, transition=cycle([op]), **kw, **c)
    with pytest.raises(TypeError):
        ChainEnsemble(lr_target, RandomWalk(0.05), 2, schedule=object(), **kw)
