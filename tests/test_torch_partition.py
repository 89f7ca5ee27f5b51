"""The port's subposterior layer (``repro_torch.partition``), its
``TargetSpec`` recipes, streaming append and the ``gaussian_mean`` family,
against the JAX package's.

The same numpy inputs go through both packages. Index arrays, sliced pools
and every combination rule are host float64 numpy or integers on both
sides, so they are held exactly (``product_combine`` draws from
``np.random.default_rng`` with the same seed, ``combine_snapshots`` seeds it
with the same ``crc32``). The ``gaussian_mean`` family is fp32 arithmetic
in two orders of reduction, held to 1e-5 relative. The statistics of the
combined draws are held to the conjugate model's closed-form posterior at
the reference's own bars (``tests/test_subposterior.py``), on the port's
chains. Everything runs on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import partition as j_part
from repro.core import target_builder as j_tb
from repro.serving.resident import Snapshot as JSnapshot
from repro_torch import partition as part
from repro_torch.core import (ChainEnsemble, RandomWalk, SubsampledMHConfig, append_observations,
                              build_target, spec_of)
from repro_torch.core import target_builder as tb
from repro_torch.serving import FreshnessPolicy, ResidentEnsemble
from repro_torch.serving.resident import Snapshot

torch.set_num_threads(1)

# fp32 sums of D squared differences, reduced in two orders
GM_RTOL, GM_ATOL = 1e-5, 1e-5


def _prior_t(th):
    return -0.5 * (th ** 2).sum(-1)


def _prior_j(th):
    return -0.5 * jnp.sum(th ** 2, axis=-1)


def _gm_pair(x: np.ndarray):
    """The same gaussian_mean target in both packages."""
    n = x.shape[0]
    return (build_target("gaussian_mean", torch.from_numpy(x), n, prior_logpdf=_prior_t),
            j_tb.build_target("gaussian_mean", jnp.asarray(x), n, prior_logpdf=_prior_j))


# ---------------------------------------------------------------------------
# Partitioner: exact against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["stride", "block"])
@pytest.mark.parametrize("n,num_p", [(10, 1), (10, 3), (7, 7), (64, 4), (12_000, 4)])
def test_partition_indices_equal_reference(n, num_p, scheme):
    got, want = part.partition_indices(n, num_p, scheme), j_part.partition_indices(n, num_p, scheme)
    assert len(got) == len(want) == num_p
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got).tolist()) == list(range(n))


@pytest.mark.parametrize("n_before,n_new,num_p", [(10, 7, 3), (8, 1, 4), (5, 0, 2),
                                                  (12_000, 750, 4)])
def test_partition_append_indices_equal_reference_and_extend_stride(n_before, n_new, num_p):
    got = part.partition_append_indices(n_before, n_new, num_p)
    for g, w in zip(got, j_part.partition_append_indices(n_before, n_new, num_p)):
        np.testing.assert_array_equal(g, w)
    before = part.partition_indices(n_before, num_p)
    after = part.partition_indices(n_before + n_new, num_p) if n_new else before
    for p in range(num_p):
        np.testing.assert_array_equal(np.concatenate([before[p], got[p] + n_before]), after[p])


def test_partitioner_refuses_what_the_reference_refuses():
    for args in ((3, 4), (8, 0), (8, 2, "zigzag")):
        with pytest.raises(ValueError):
            part.partition_indices(*args)
    with pytest.raises(ValueError):
        part.partition_append_indices(8, 4, 2, scheme="block")


def test_take_sections_equals_reference_on_numpy_and_tensor_leaves():
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(20, 3)).astype(np.float32), np.sign(rng.normal(size=20)))
    idx = part.partition_indices(20, 3)[1]
    want = j_part.take_sections(tuple(jnp.asarray(a) for a in data), idx)
    for leaves in (data, tuple(torch.from_numpy(a) for a in data)):
        got = part.take_sections(leaves, idx)
        assert type(got[0]) is type(leaves[0])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("num_p,scheme", [(2, "stride"), (4, "stride"), (3, "block")])
def test_partition_spec_slices_and_tempers_as_the_reference(num_p, scheme):
    """Per-shard data and prior_scale of a logit target's recipe, both
    packages from the same numpy pool."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    y = np.where(rng.random(50) < 0.5, 1.0, -1.0).astype(np.float32)
    t = build_target("logit", (torch.from_numpy(x), torch.from_numpy(y)), 50,
                     prior_logpdf=_prior_t)
    jt = j_tb.build_target("logit", (jnp.asarray(x), jnp.asarray(y)), 50, prior_logpdf=_prior_j)
    got = part.partition_spec(spec_of(t), num_p, scheme)
    want = j_part.partition_spec(j_tb.spec_of(jt), num_p, scheme)
    for g, w in zip(got, want):
        assert g.num_sections == w.num_sections and g.prior_scale == w.prior_scale
        assert g.family == w.family == "logit"
        for gl, wl in zip(g.data, w.data):
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_partition_target_p1_is_the_same_object_and_specless_targets_refuse():
    t, _ = _gm_pair(np.zeros((6, 2), np.float32))
    parts = part.partition_target(t, 1)
    assert len(parts) == 1 and parts[0] is t
    hand = build_target("gaussian_mean", lambda th: torch.zeros(6, 2), 6, prior_logpdf=_prior_t)
    assert hand.spec is None
    with pytest.raises(ValueError, match="no TargetSpec"):
        part.partition_target(hand, 2)


def test_tempered_subposteriors_sum_to_the_full_posterior():
    x = (np.random.default_rng(3).normal(size=(768, 2)) + [0.6, -0.3]).astype(np.float32)
    t, _ = _gm_pair(x)
    theta = torch.tensor([0.25, -0.8])
    full = float(t.log_density(theta))
    for num_p in (2, 4):
        parts = part.partition_target(t, num_p)
        assert all(p.spec.prior_scale == pytest.approx(1.0 / num_p) for p in parts)
        total = sum(float(p.log_density(theta)) for p in parts)
        assert total == pytest.approx(full, rel=1e-5, abs=1e-3)


# ---------------------------------------------------------------------------
# Combination: exact against the reference (float64 numpy on both sides)
# ---------------------------------------------------------------------------


def _dict_draws(rng, k=3, w=5):
    # insertion order unlike the sorted order the reference flattens in
    return {"b": rng.normal(size=(k, w)).astype(np.float32),
            "a": rng.normal(size=(k, w, 2)).astype(np.float32)}


def test_flatten_unflatten_trim_equal_reference():
    rng = np.random.default_rng(4)
    draws = _dict_draws(rng)
    flat = part.flatten_draws(draws)
    np.testing.assert_array_equal(flat, j_part.flatten_draws(draws))
    assert flat.shape == (15, 3)
    back = part.unflatten_draws(flat, draws)
    want = j_part.unflatten_draws(flat, draws)
    assert list(back) == list(draws)
    for key in draws:
        assert back[key].dtype == np.float32
        np.testing.assert_array_equal(back[key], draws[key])
        np.testing.assert_array_equal(back[key], np.asarray(want[key]))
    a, b = rng.normal(size=(2, 10, 3)), rng.normal(size=(2, 6, 3))
    for g, w in zip(part.trim_windows([a, b]), j_part.trim_windows([a, b])):
        np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError):
        part.trim_windows([a, rng.normal(size=(3, 6, 3))])


def _flats(rng, num_p=3, s=40, d=3):
    return [rng.normal(loc=p, size=(s, d)) @ np.diag([1.0, 2.0, 0.5]) for p in range(num_p)]


def test_combination_rules_equal_reference():
    rng = np.random.default_rng(5)
    flats = _flats(rng)
    np.testing.assert_array_equal(part.consensus_combine(flats),
                                  j_part.consensus_combine(flats))
    for g, w in zip(part.product_moments(flats), j_part.product_moments(flats)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(part.product_combine(flats, 60, seed=17),
                                  j_part.product_combine(flats, 60, seed=17))
    with pytest.raises(ValueError):
        part.consensus_combine([rng.normal(size=(10, 2)), rng.normal(size=(8, 2))])


@pytest.mark.parametrize("method", ["consensus", "product"])
def test_combine_draws_and_snapshots_equal_reference(method):
    rng = np.random.default_rng(6)
    windows = [_dict_draws(rng, w=w) for w in (6, 8, 7)]
    got = part.combine_draws(windows, method, seed=17)
    want = j_part.combine_draws(windows, method, seed=17)
    for key in ("a", "b"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert part.combine_draws(windows[:1], method) is windows[0]
    fields = [(32, 0.5), (48, 2.5), (40, 1.0)]
    snaps = [Snapshot(d, 18, v, s, {}, 0.0) for d, (v, s) in zip(windows, fields)]
    jsnaps = [JSnapshot(d, 18, v, s, {}, 0.0) for d, (v, s) in zip(windows, fields)]
    combined, jcombined = part.combine_snapshots(snaps, method), j_part.combine_snapshots(
        jsnaps, method)
    assert combined.steps_done == jcombined.steps_done == 120  # the version sum
    assert combined.staleness_s == jcombined.staleness_s == 2.5  # the stalest input
    assert combined.num_draws == jcombined.num_draws == 18
    assert combined.summary == jcombined.summary == {
        "combine": {"method": method, "partitions": 3}}
    for key in ("a", "b"):  # product: the same crc32 seed of the version tuple
        np.testing.assert_array_equal(combined.draws[key], np.asarray(jcombined.draws[key]))
    with pytest.raises(RuntimeError, match="no window"):
        part.combine_snapshots([snaps[0], snaps[1]._replace(draws=None)])


# ---------------------------------------------------------------------------
# The gaussian_mean family and appended targets: fp32 against the reference
# ---------------------------------------------------------------------------


def _gm_inputs(rng, n=40, d=3, k=4, m=9):
    x = rng.normal(size=(n, d)).astype(np.float32)
    th, thp = (rng.normal(size=(k, d)).astype(np.float32) for _ in range(2))
    idx = rng.integers(0, n, size=(k, m)).astype(np.int32)
    return x, th, thp, idx


def _hold_family(t_fam, j_fam, x, th, thp, idx):
    tx = torch.from_numpy(x)
    pairs = [
        (t_fam.loglik(tx, torch.from_numpy(th[0]), torch.from_numpy(idx[0])),
         j_fam.loglik(jnp.asarray(x), jnp.asarray(th[0]), jnp.asarray(idx[0]))),
        (t_fam.delta(tx, torch.from_numpy(th[0]), torch.from_numpy(thp[0]),
                     torch.from_numpy(idx[0])),
         j_fam.delta(jnp.asarray(x), jnp.asarray(th[0]), jnp.asarray(thp[0]),
                     jnp.asarray(idx[0]))),
        (t_fam.ensemble_delta(tx, torch.from_numpy(th), torch.from_numpy(thp),
                              torch.from_numpy(idx)),
         j_fam.ensemble_delta(jnp.asarray(x), jnp.asarray(th), jnp.asarray(thp),
                              jnp.asarray(idx))),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GM_RTOL, atol=GM_ATOL)


@pytest.mark.parametrize("d", [1, 2, 5])
def test_gaussian_mean_family_matches_reference(d):
    rng = np.random.default_rng(d)
    _hold_family(tb.get_family("gaussian_mean"), j_tb.get_family("gaussian_mean"),
                 *_gm_inputs(rng, d=d))


def test_appended_target_matches_reference_appended_target():
    rng = np.random.default_rng(8)
    x, th, thp, _ = _gm_inputs(rng, n=30)
    extra = rng.normal(size=(11, 3)).astype(np.float32)
    t, jt = _gm_pair(x)
    t2, jt2 = append_observations(t, extra), j_tb.append_observations(jt, extra)
    assert t2.num_sections == jt2.num_sections == 41
    np.testing.assert_array_equal(spec_of(t2).data.numpy(), np.asarray(j_tb.spec_of(jt2).data))
    idx = rng.integers(0, 41, size=(4, 12)).astype(np.int32)
    got = t2.log_local_ensemble(torch.from_numpy(th), torch.from_numpy(thp),
                                torch.from_numpy(idx))
    want = jt2.log_local_ensemble(jnp.asarray(th), jnp.asarray(thp), jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GM_RTOL, atol=GM_ATOL)
    np.testing.assert_allclose(float(t2.log_density(torch.from_numpy(th[0]))),
                               float(jt2.log_density(jnp.asarray(th[0]))), rtol=GM_RTOL)


def test_prior_scale_one_keeps_the_untempered_closures_and_spec_composes():
    x = np.random.default_rng(9).normal(size=(12, 2)).astype(np.float32)
    t, _ = _gm_pair(x)
    theta, theta_p = torch.tensor([0.1, 0.2]), torch.tensor([-0.3, 0.4])
    assert t.spec.prior_logpdf is _prior_t and t.spec.prior_scale == 1.0
    half = tb.build_from_spec(dataclasses.replace(spec_of(t), prior_scale=0.5))
    assert half.spec.prior_logpdf is _prior_t  # untempered: tempering composes
    assert float(half.log_global(theta, theta_p)) == pytest.approx(
        0.5 * float(t.log_global(theta, theta_p)), rel=1e-6)


def _toy_target(x):
    return build_target("gaussian_mean", torch.as_tensor(x), int(np.shape(x)[0]),
                        prior_logpdf=_prior_t)


@pytest.mark.parametrize("chunks", [[], [1], [7], [3, 4], [1, 1, 1, 1], [2, 7, 5, 6]])
def test_append_chunking_matches_full_rebuild(chunks):
    """Any chunking of an append equals one build on the concatenated pool:
    the same data, the same log density, bit for bit."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(9, 2)).astype(np.float32)
    extra = rng.normal(size=(sum(chunks), 2)).astype(np.float32)
    target, offset = _toy_target(base), 0
    for size in chunks:
        target = append_observations(target, extra[offset:offset + size])
        offset += size
    rebuilt = _toy_target(np.concatenate([base, extra]))
    assert target.num_sections == rebuilt.num_sections
    assert torch.equal(spec_of(target).data, spec_of(rebuilt).data)
    theta = torch.tensor([0.3, -0.2])
    assert float(target.log_density(theta)) == float(rebuilt.log_density(theta))


def test_append_refuses_mismatched_data_and_empty_append_is_identity():
    target = _toy_target(np.zeros((5, 2), np.float32))
    assert append_observations(target, np.zeros((0, 2), np.float32)) is target
    with pytest.raises(ValueError, match="section shape"):
        append_observations(target, np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="structure"):
        append_observations(target, (np.zeros((3, 2)), np.zeros(3)))
    appended = append_observations(target, np.ones((2, 2), np.float64))
    assert appended.spec.data.dtype == torch.float32  # the pool's dtype


# ---------------------------------------------------------------------------
# Streaming append into a resident
# ---------------------------------------------------------------------------


def _make_resident(x, *, seed=0, window=8, refresh_steps=4, sampler="stream"):
    target = _toy_target(x)
    cfg = SubsampledMHConfig(batch_size=min(16, target.num_sections), epsilon=0.01,
                             sampler=sampler)
    ens = ChainEnsemble(target, RandomWalk(0.15), 2, config=cfg, device="cpu")
    return ResidentEnsemble(ens, torch.zeros(2), seed=seed, window=window,
                            refresh_steps=refresh_steps, name="stream-test")


def test_resident_append_then_refresh_matches_concat_build():
    rng = np.random.default_rng(12)
    base = rng.normal(size=(20, 2)).astype(np.float32)
    extra = rng.normal(size=(12, 2)).astype(np.float32)
    streamed = _make_resident(base)
    assert streamed.append(extra) == 12
    assert streamed.ensemble.target.num_sections == 32
    rebuilt = _make_resident(np.concatenate([base, extra]))
    streamed.refresh()
    rebuilt.refresh()
    np.testing.assert_array_equal(streamed.snapshot().draws, rebuilt.snapshot().draws)


@pytest.mark.parametrize("sampler", ["stream", "fy"])
def test_resident_append_continues_running_chains(sampler):
    """Mid-run: theta, steps and the generator carry over, the window stays,
    the sampler state is made anew for the grown pool, and the next refresh
    advances on the grown target."""
    rng = np.random.default_rng(13)
    res = _make_resident(rng.normal(size=(20, 2)).astype(np.float32), sampler=sampler)
    res.refresh()
    res.refresh()
    theta, draws, gen = res.state.theta.clone(), res.snapshot().draws, res._gen_state.clone()
    assert res.append(rng.normal(size=(8, 2)).astype(np.float32)) == 8
    assert res.steps_done == 8
    assert torch.equal(res.state.theta, theta) and torch.equal(res._gen_state, gen)
    np.testing.assert_array_equal(res.snapshot().draws, draws)
    if sampler == "fy":
        assert res.state.sampler_state.capacity == 28  # no buffer of the old N
    res.refresh()
    assert res.steps_done == 12 and res.ensemble.target.num_sections == 28


def test_resident_empty_append_is_a_bitwise_noop():
    res = _make_resident(np.random.default_rng(14).normal(size=(10, 2)).astype(np.float32))
    res.refresh()
    target, state = res.ensemble.target, res._state
    assert np.isfinite(res.snapshot().staleness_s)
    assert res.append(np.zeros((0, 2), np.float32)) == 0
    assert res.ensemble.target is target and res._state is state
    assert np.isfinite(res.snapshot().staleness_s)  # the clock was not reset


def test_append_resets_freshness_staleness():
    rng = np.random.default_rng(15)
    res = _make_resident(rng.normal(size=(16, 2)).astype(np.float32))
    policy = FreshnessPolicy(max_staleness_s=3600.0, min_draws=4)
    res.refresh()
    assert policy.is_fresh(res.snapshot())
    res.append(rng.normal(size=(4, 2)).astype(np.float32))
    snap = res.snapshot()
    assert snap.staleness_s == float("inf")
    assert "stale" in policy.stale_reason(snap)
    res.refresh()  # one refresh folds the rows in and the gate admits again
    assert policy.is_fresh(res.snapshot())


# ---------------------------------------------------------------------------
# The conjugate ground-truth harness, on the port's chains
# ---------------------------------------------------------------------------

# The reference harness's settings (tests/conftest.py: conjugate_posterior).
H_N, H_D, H_K, H_BURN, H_KEEP = 768, 2, 4, 250, 350


@pytest.fixture(scope="module")
def harness():
    """Prior N(0, I), x_i ~ N(theta, I): the exact posterior is N(n xbar /
    (n+1), I/(n+1)). ``run(P)`` gives the P per-partition windows (K, W, D)
    of the port's chains on the stride-partitioned, tempered targets."""
    rng = np.random.default_rng(3)
    x = (np.array([0.6, -0.3]) + rng.normal(size=(H_N, H_D))).astype(np.float32)
    target = _toy_target(x)
    xbar = x.astype(np.float64).mean(0)
    cache = {}

    def run(num_p):
        if num_p not in cache:
            draws = []
            for p, t in enumerate(part.partition_target(target, num_p)):
                cfg = SubsampledMHConfig(batch_size=min(128, t.num_sections), epsilon=0.005,
                                         sampler="stream")
                sigma = 1.7 * float(np.sqrt(num_p / (H_N + 1.0)))
                ens = ChainEnsemble(t, RandomWalk(sigma), H_K, config=cfg, device="cpu")
                gen = torch.Generator().manual_seed(4 + 97 * num_p + p)
                state, _, _ = ens.run(gen, ens.init(torch.zeros(H_D)), H_BURN)
                _, samples, _ = ens.run(gen, state, H_KEEP)
                draws.append(samples.numpy())
            cache[num_p] = draws
        return cache[num_p]

    return {"run": run, "post_mean": H_N * xbar / (H_N + 1.0), "post_var": 1.0 / (H_N + 1.0)}


@pytest.mark.parametrize("num_p", [1, 2, 4])
@pytest.mark.parametrize("method", ["consensus", "product"])
def test_combination_recovers_conjugate_posterior(harness, num_p, method):
    """The reference's bar: the combined mean within 0.5 posterior std of
    the exact one, the variance ratio in [0.45, 2.2]."""
    draws = harness["run"](num_p)
    combined = np.asarray(part.combine_draws(draws, method, seed=17),
                          np.float64).reshape(-1, H_D)
    post_std = np.sqrt(harness["post_var"])
    err_mean = np.max(np.abs(combined.mean(0) - harness["post_mean"])) / post_std
    assert err_mean < 0.5, f"P={num_p} {method}: mean off by {err_mean:.2f} posterior std"
    var_ratio = combined.var(axis=0, ddof=1) / harness["post_var"]
    assert np.all(var_ratio > 0.45) and np.all(var_ratio < 2.2), (
        f"P={num_p} {method}: variance ratio {var_ratio} outside [0.45, 2.2]")
    if num_p == 1:
        assert part.combine_draws(draws, method) is draws[0]


def test_combination_invariant_under_partition_permutation(harness):
    draws = harness["run"](4)
    perm = [2, 0, 3, 1]
    np.testing.assert_allclose(part.combine_draws([draws[i] for i in perm], "consensus"),
                               part.combine_draws(draws, "consensus"), rtol=1e-8, atol=1e-10)
    flats = [part.flatten_draws(d) for d in draws]
    for g, w in zip(part.product_moments([flats[i] for i in perm]), part.product_moments(flats)):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
