"""The port's joint DP mixture (paper Sec. 4.2) against the JAX package.

Inputs come from numpy with a seed, or from the reference's own ``synth`` and
``init_state`` at n = 600, carried across by ``repro_torch.convert``. The
port's wrappers take their plain PyTorch versions because the tensors lie on
the CPU. Deterministic pieces (the NIW predictive, the alpha log ratio, the
exact w decision) are held value for value; the random moves, whose numbers
come from a ``torch.Generator`` on one side and threefry keys on the other,
are held by distribution over many seeds and keys.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.experiments import jointdpm as jdp
from repro.inference import niw as jniw
from repro.kernels.ref import logit_loglik as j_logit_loglik
from repro_torch import convert
from repro_torch._device import tree_leaves, tree_map
from repro_torch.core.sequential_test import sequential_test
from repro_torch.experiments import jointdpm
from repro_torch.inference import ClusterStats, Cycle, Mixture, NIWPrior, Repeat, run_inference
from repro_torch.inference import niw
from repro_torch.kernels import ops
from repro_torch.kernels.gibbs_z import sums_drift
from repro_torch.kernels.ref import lgamma_fp32

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref_setup():
    cfg = jdp.JDPMConfig()
    data = jdp.synth(jax.random.key(0), n=600, n_test=200)
    state = jdp.init_state(jax.random.key(1), data, cfg)
    return cfg, data, state


def _port_cfg(cfg_j):
    return jointdpm.JDPMConfig(**dataclasses.asdict(cfg_j))


def _port_data(data_j):
    return convert.jdpm_data(*(np.asarray(a) for a in data_j), device="cpu")


def _port_state(state_j):
    return convert.jdpm_state(np.asarray(state_j.z), np.asarray(state_j.w),
                              np.asarray(state_j.alpha), *(np.asarray(a) for a in state_j.stats),
                              device="cpu")


def _batched(state, k):
    """K copies of one replica's state (a leading (K,) axis on every leaf)."""
    return tree_map(lambda l: l[None].repeat((k,) + (1,) * l.ndim), state)


def _random_stats(rng, k, d, n_max):
    """Statistics of real point sets (so every scatter is PSD): an empty
    cluster, a one-point cluster, the rest up to n_max points."""
    counts = rng.integers(2, n_max, k)
    counts[0], counts[1] = 0, 1
    n = counts.astype(np.float32)
    sx = np.zeros((k, d), np.float32)
    sxx = np.zeros((k, d, d), np.float32)
    for j in range(k):
        pts = (rng.standard_normal((counts[j], d)) * rng.uniform(0.3, 2.0)
               + rng.normal(0, 2, d)).astype(np.float32)
        sx[j], sxx[j] = pts.sum(0), pts.T @ pts
    m0 = rng.normal(0, 0.5, d).astype(np.float32)
    s0 = (1.3 * np.eye(d) + 0.2).astype(np.float32)
    return n, sx, sxx, m0, s0


@pytest.mark.parametrize("d,n_max", [(2, 600), (3, 600), (2, 20_000)])
def test_predictive_matches_reference(d, n_max):
    """``predictive_all_clusters`` and ``posterior_predictive_logpdf``
    against the reference on the same statistics: 1e-4 absolute at the
    test's cluster sizes (<= 600 points). With clusters of up to 2e4 points
    the Student-t's lgamma terms reach ~5e4, where one float32 ulp is
    ~4e-3 and XLA's log and log1p round differently from PyTorch's in some
    inputs: there the bound is two ulps of lgamma((df + D) / 2)."""
    rng = np.random.default_rng([d, n_max])
    n, sx, sxx, m0, s0 = _random_stats(rng, 6, d, n_max)
    xq = (2.0 * rng.standard_normal((7, d))).astype(np.float32)
    pj = jniw.NIWPrior(jnp.asarray(m0), 0.1, 4.0 + d, jnp.asarray(s0))
    pt = NIWPrior(torch.tensor(m0), 0.1, 4.0 + d, torch.tensor(s0))
    sj = jniw.ClusterStats(jnp.asarray(n), jnp.asarray(sx), jnp.asarray(sxx))
    want = np.stack([np.asarray(jniw.predictive_all_clusters(jnp.asarray(x), sj, pj)) for x in xq])
    st = ClusterStats(*map(torch.tensor, (n, sx, sxx)))
    got = niw.predictive_all_clusters(torch.tensor(xq), st, pt).numpy()
    df = 4.0 + d + n - d + 1.0
    lg = np.asarray(jax.lax.lgamma(jnp.asarray((df + d) / 2.0, jnp.float32)))
    tol = np.maximum(1e-4, 2 * np.spacing(np.abs(lg)))
    assert np.all(np.abs(got - want) <= tol[None, :]), np.abs(got - want).max(0)
    one = niw.posterior_predictive_logpdf(torch.tensor(xq[0]), torch.tensor(n[3]),
                                          torch.tensor(sx[3]), torch.tensor(sxx[3]), pt)
    want_one = jniw.posterior_predictive_logpdf(jnp.asarray(xq[0]), jnp.asarray(n[3]),
                                                jnp.asarray(sx[3]), jnp.asarray(sxx[3]), pj)
    assert abs(float(one) - float(want_one)) <= tol[3]


def test_lgamma_reflection_matches_xla():
    """Below 0.5 the port's lgamma reflects as XLA's does (alpha reaches
    there): within 2e-6 of ``jax.lax.lgamma`` (the sine and logs differ by
    an ulp); above it the Lanczos form is unchanged."""
    x = np.random.default_rng(0).uniform(1e-3, 0.5, 4000).astype(np.float32)
    x = np.concatenate([x, np.float32([1e-3, 0.25, 0.49999997])])
    want = np.asarray(jax.lax.lgamma(jnp.asarray(x)))
    np.testing.assert_allclose(lgamma_fp32(torch.tensor(x)).numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n_total", [600, 10_000])
def test_alpha_log_ratio_matches_reference(n_total):
    """The alpha move's log ratio for given (alpha, alpha', counts) against
    the reference's formula: within two float32 ulps of lgamma(alpha + n)
    (its value dominates the ratio: ~3e3 at n = 600, ~8e4 at n = 1e4)."""
    cfg = jdp.JDPMConfig()
    counts = np.zeros(20, np.float32)
    counts[:5] = np.float32([0.3, 0.25, 0.2, 0.15, 0.1]) * n_total
    for a, ap in ((0.05, 0.07), (0.3, 0.2), (1.0, 1.4), (2.5, 1.7), (0.45, 0.55)):
        def post(alpha):
            log_alpha = jnp.log(alpha)
            prior = (cfg.alpha_a * jnp.log(cfg.alpha_rate) + (cfg.alpha_a - 1) * log_alpha
                     - cfg.alpha_rate * alpha)
            return prior + jdp._crp_log_partition(alpha, jnp.asarray(counts)) + log_alpha

        want = float(post(jnp.float32(ap)) - post(jnp.float32(a)))
        at, apt, ct = torch.tensor(a), torch.tensor(ap), torch.tensor(counts)
        pcfg = _port_cfg(cfg)
        got = float(jointdpm.alpha_log_posterior(apt, torch.log(apt), ct, pcfg)
                    - jointdpm.alpha_log_posterior(at, torch.log(at), ct, pcfg))
        ulp = float(np.spacing(np.float32(jax.lax.lgamma(jnp.float32(a + n_total)))))
        assert abs(got - want) <= 2 * ulp, (a, ap, got, want)


def test_mh_alpha_moves_only_alpha(ref_setup):
    cfg_j, data_j, state_j = ref_setup
    st = _port_state(state_j)
    gen = torch.Generator().manual_seed(0)
    moved = [float(jointdpm.mh_alpha(gen, st, _port_cfg(cfg_j)).alpha) for _ in range(50)]
    assert any(m != 1.0 for m in moved) and any(m == 1.0 for m in moved)  # accepts and rejects
    new = jointdpm.mh_alpha(gen, st, _port_cfg(cfg_j))
    assert torch.equal(new.z, st.z) and torch.equal(new.w, st.w)


@pytest.mark.parametrize("k_max", [20, 3])
def test_gibbs_conditional_matches_reference(k_max, ref_setup):
    """One Gibbs step's pick for a fixed state and point: the port's
    frequencies over 4000 draws (4000 replicas of the state, one generator)
    against the reference's over 4000 keys, total variation <= 0.05 (for two
    samples of 4000 over a handful of clusters it is ~0.02). K_max = 3 with
    three occupied clusters has no empty slot: both take slot 0 as the
    auxiliary, an occupied cluster whose w the fresh draw replaces for the
    evaluation."""
    _, data_j, _ = ref_setup
    cfg_j = dataclasses.replace(jdp.JDPMConfig(), k_max=k_max)
    state_j = jdp.init_state(jax.random.key(1), data_j, cfg_j)
    if k_max == 20:  # a few sweeps first, so that clusters differ
        n = data_j.x.shape[0]
        state_j = jdp.gibbs_z_steps(jax.random.key(7), state_j, data_j, cfg_j,
                                    jax.random.permutation(jax.random.key(8), n))
    assert (k_max == 3) == bool(np.all(np.asarray(state_j.stats.n) > 0.5))
    i, draws = 5, 4000
    pts = jnp.asarray([i])
    keys = jax.random.split(jax.random.key(11), draws)
    picks_j = np.asarray(jax.jit(jax.vmap(
        lambda k: jdp.gibbs_z_steps(k, state_j, data_j, cfg_j, pts).z[i]))(keys))
    st = _batched(_port_state(state_j), draws)
    gen = torch.Generator().manual_seed(12)
    new = jointdpm.batched_gibbs_z_steps(gen, st, _port_data(data_j), _port_cfg(cfg_j),
                                         torch.full((draws, 1), i, dtype=torch.int32))
    picks_t = new.z[:, i].numpy()
    hist = lambda p: np.bincount(p, minlength=k_max) / draws
    tv = 0.5 * np.abs(hist(picks_j) - hist(picks_t)).sum()
    assert tv <= 0.05, (hist(picks_j), hist(picks_t))
    assert len(np.unique(picks_t)) >= 2


@pytest.mark.parametrize("k_max", [20, 3])
def test_sweep_keeps_counts(k_max, ref_setup):
    """The reference's own check (tests/test_experiments.py): after a sweep
    over half the points the counts equal z's histogram exactly; the sums
    are within 1e-5 of their largest magnitude of sums recomputed from z in
    float64 (float32 adds and removes round to the running sum's ulp);
    points outside the sweep keep their cluster."""
    _, data_j, _ = ref_setup
    cfg_j = dataclasses.replace(jdp.JDPMConfig(), k_max=k_max)
    state_j = jdp.init_state(jax.random.key(1), data_j, cfg_j)
    st, data, cfg = _port_state(state_j), _port_data(data_j), _port_cfg(cfg_j)
    pts = torch.tensor(np.asarray(jax.random.permutation(jax.random.key(2), 600)[:300]))
    new = jointdpm.gibbs_z_steps(torch.Generator().manual_seed(3), st, data, cfg, pts)
    assert float(new.stats.n.sum()) == 600
    assert torch.equal(new.stats.n, torch.bincount(new.z.long(), minlength=k_max).float())
    assert sums_drift(new.stats, ClusterStats.from_assignments(data.x, new.z, k_max)) <= 1e-5
    rest = torch.ones(600, dtype=torch.bool)
    rest[pts.long()] = False
    assert torch.equal(new.z[rest], st.z[rest])
    assert not torch.equal(new.z, st.z)


def test_init_stats_match_reference(ref_setup):
    """The float64-summed statistics of the reference's z against the
    reference's point-by-point float32 sums: within 1e-3; the predictive
    probabilities of the same state within 1e-4."""
    cfg_j, data_j, state_j = ref_setup
    data, st = _port_data(data_j), _port_state(state_j)
    again = ClusterStats.from_assignments(data.x, st.z, cfg_j.k_max)
    for got, want in zip(again, st.stats):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    want = np.asarray(jdp.predict_proba(state_j, data_j.x_test, cfg_j))
    got = jointdpm.predict_proba(st, data.x_test, _port_cfg(cfg_j)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert jointdpm.accuracy(got, data.y_test) == jdp.accuracy(want, np.asarray(data_j.y_test))


def test_exact_w_move_decision_matches_reference(ref_setup):
    """``exact=True``: the decision equals the one the reference's
    ``logit_loglik`` gives over the expert's members for the port's w' and
    log u (drawn again from a copy of the generator), and every member is
    evaluated."""
    cfg_j, data_j, state_j = ref_setup
    st, data, cfg = _port_state(state_j), _port_data(data_j), _port_cfg(cfg_j)
    x_np, y_np, z_np = np.asarray(data_j.x), np.asarray(data_j.y), np.asarray(state_j.z)
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        twin = torch.Generator()
        twin.set_state(gen.get_state())
        prop = jointdpm.propose_w(twin, jointdpm._batch(st), 0.3)
        new, info = jointdpm.subsampled_mh_w(gen, st, data, cfg, batch_size=50, sigma_prop=0.3,
                                             exact=True)
        k = int(prop.cluster[0])
        members = np.nonzero(z_np == k)[0]
        assert int(info.cluster) == k and int(info.n_evaluated) == int(info.n_k) == len(members)
        xi = jnp.asarray(np.concatenate([x_np[members], np.ones((len(members), 1), np.float32)], 1))
        wc, wp = jnp.asarray(prop.w_cur[0].numpy()), jnp.asarray(prop.w_prop[0].numpy())
        total = float(jnp.sum(j_logit_loglik(wp, xi, y_np[members])
                              - j_logit_loglik(wc, xi, y_np[members])))
        g = -0.5 / cfg.prior_var_w * (float(jnp.sum(wp ** 2)) - float(jnp.sum(wc ** 2)))
        mu, mu0 = total / len(members), (float(prop.log_u[0]) - g) / len(members)
        assert abs(mu - mu0) > 1e-5  # not a borderline decision
        assert bool(info.accepted) == (mu > mu0)
        assert torch.equal(new.w[k], prop.w_prop[0] if bool(info.accepted) else st.w[k])


def test_subsampled_w_move_matches_reference_in_distribution(ref_setup):
    """Subsampled (batch 50, epsilon 0.1, sigma 0.3): n_evaluated <= n_k on
    every draw; acceptance within 0.15 and the mean n_evaluated / n_k
    within 0.1 of the reference's, the port over 200 replicas of the state
    (one generator), the reference over 200 keys. Both spread ~0.03 at 200
    draws."""
    cfg_j, data_j, state_j = ref_setup
    keys = jax.random.split(jax.random.key(21), 200)
    info_j = jax.jit(jax.vmap(lambda k: jdp.subsampled_mh_w(
        k, state_j, data_j, cfg_j, batch_size=50, epsilon=0.1, sigma_prop=0.3)[1]))(keys)
    st = _batched(_port_state(state_j), 200)
    gen = torch.Generator().manual_seed(22)
    _, info = jointdpm.batched_subsampled_mh_w(gen, st, _port_data(data_j), _port_cfg(cfg_j),
                                               batch_size=50, epsilon=0.1, sigma_prop=0.3)
    assert bool((info.n_evaluated <= info.n_k).all())
    frac_t = float((info.n_evaluated.double() / info.n_k.double()).mean())
    frac_j = float(np.mean(np.asarray(info_j.n_evaluated) / np.asarray(info_j.n_k)))
    acc_t, acc_j = float(info.accepted.double().mean()), float(np.mean(np.asarray(info_j.accepted)))
    assert abs(acc_t - acc_j) <= 0.15, (acc_t, acc_j)
    assert abs(frac_t - frac_j) <= 0.1, (frac_t, frac_j)


def _slice_draw(gen, st, m, active=None, *, mode="auto"):
    """Contiguous positions of each chain's own pool (pos, n): a stream
    draw whose pool size is per chain."""
    pos, n = st
    offs = pos[..., None] + torch.arange(m, dtype=torch.int32)
    valid = offs < n[..., None]
    new_pos = torch.minimum(pos + m, n)
    if active is not None:
        new_pos = torch.where(active, new_pos, pos)
    return (new_pos, n), torch.minimum(offs, n[..., None] - 1), valid


def test_per_chain_pool_size_sequential_test():
    """A (K,) tensor ``num_sections`` runs each chain against its own pool:
    decisions, rounds and counts equal those of scalar calls chain by
    chain, the mean and p-value within 1e-6 (the same float32 steps over
    batched rows), with pools that run out (exhaustion at each chain's own
    N). Without ``max_rounds`` a tensor pool size raises."""
    rng = np.random.default_rng(0)
    sizes = np.array([7, 60, 150, 333, 1000, 45], np.int32)
    vals = rng.normal(0.02, 1.0, (len(sizes), 1000)).astype(np.float32)
    mu0 = rng.normal(0.0, 0.05, len(sizes)).astype(np.float32)
    values = torch.tensor(vals)
    n_t = torch.tensor(sizes)
    res = sequential_test(None, torch.tensor(mu0), _slice_draw,
                          lambda idx: values.gather(1, idx.long()),
                          (torch.zeros(len(sizes), dtype=torch.int32), n_t), n_t, 50, 0.05,
                          max_rounds=20)
    for c, n in enumerate(sizes):
        one = sequential_test(None, torch.tensor(mu0[c]), _slice_draw,
                              lambda idx: values[c][idx.long()],
                              (torch.zeros((), dtype=torch.int32), torch.tensor(n)), int(n), 50,
                              0.05, max_rounds=20)
        assert bool(res.decision[c]) == bool(one.decision)
        assert int(res.rounds[c]) == int(one.rounds)
        assert int(res.n_evaluated[c]) == int(one.n_evaluated) <= n
        assert abs(float(res.mu_hat[c]) - float(one.mu_hat)) <= 1e-6
        assert abs(float(res.pvalue[c]) - float(one.pvalue)) <= 1e-6
    assert int(res.n_evaluated[0]) == 7  # the small pool runs out
    with pytest.raises(ValueError, match="max_rounds"):
        sequential_test(None, torch.tensor(mu0), _slice_draw,
                        lambda idx: values.gather(1, idx.long()),
                        (torch.zeros(len(sizes), dtype=torch.int32), n_t), n_t, 50, 0.05)


def test_ensemble_of_one_equals_sequential(ref_setup):
    """The port's K = 1 invariant: an ensemble of one replica, with the
    same seed and state0, gives the sequential run's samples and infos bit
    for bit (the batched forms draw what the one-replica forms draw)."""
    cfg_j, data_j, state_j = ref_setup
    st, data, cfg = _port_state(state_j), _port_data(data_j), _port_cfg(cfg_j)
    kw = dict(w_moves=3, batch_size=50)
    _, s_seq, i_seq = jointdpm.run_posterior_sequential(4, data, cfg, 3, state0=st, device="cpu",
                                                        **kw)
    _, s_ens, i_ens, diag = jointdpm.run_posterior_ensemble(4, data, cfg, 1, 3, state0=st,
                                                            device="cpu", **kw)
    for a, b in zip(tree_leaves(s_ens) + tree_leaves(i_ens),
                    tree_leaves(s_seq) + tree_leaves(i_seq)):
        assert torch.equal(a[0], b)
    assert i_seq["w"].n_k.shape == (3, 3) and diag["k_active_final"].shape == (1,)


def test_ensemble_runs_replicas(ref_setup):
    """K = 3 replicas, two cycles: per-replica samples and w-move infos of
    (K, cycles, moves), counts that still match each replica's z."""
    cfg_j, data_j, _ = ref_setup
    data, cfg = _port_data(data_j), _port_cfg(cfg_j)
    state, samples, infos, diag = jointdpm.run_posterior_ensemble(
        0, data, cfg, 3, 2, device="cpu", w_moves=2, batch_size=50)
    assert samples["w"].shape == (3, 2, 20, 3) and infos["w"].accepted.shape == (3, 2, 2)
    assert diag["w_accept_rate"].shape == (3,) and 0 < diag["w_frac_evaluated"] <= 1
    theta = state.theta
    for k in range(3):
        counts = torch.bincount(theta.z[k].long(), minlength=20).float()
        assert torch.equal(theta.stats.n[k], counts)


def test_convert_round_trip(ref_setup):
    """The reference's data and state carried across and back are the same
    arrays; z stays int32, and x_aug is [x, 1]."""
    cfg_j, data_j, state_j = ref_setup
    data, st = _port_data(data_j), _port_state(state_j)
    for a, b in zip(data[:4], data_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(data.x_aug[:, :2].numpy(), np.asarray(data_j.x))
    assert bool((data.x_aug[:, 2] == 1).all())
    assert st.z.dtype == torch.int32
    for a, b in zip(tree_leaves(st), jax.tree.leaves(state_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cluster_stats_add_remove_round_trip():
    """Adding then removing points per replica leaves the statistics at
    zero (the reference's round-trip test, batched over two replicas)."""
    stats = ClusterStats.empty(4, 2, (2,), device="cpu")
    xs = [torch.tensor([[1.0, 2.0], [0.5, -1.0]]), torch.tensor([[-0.5, 0.3], [2.0, 2.0]])]
    k = torch.tensor([1, 3])
    for x in xs:
        stats = stats.add(k, x)
    assert stats.n.tolist() == [[0, 2, 0, 0], [0, 0, 0, 2]]
    for x in xs:
        stats = stats.remove(k, x)
    assert float(stats.n.abs().max()) == 0 and float(stats.sum_x.abs().max()) < 1e-6
    assert float(stats.sum_xxt.abs().max()) < 1e-6


def test_inference_combinators():
    """Cycle applies its kernels in order, Repeat n times, Mixture one
    kernel a call by its weights; run_inference drives a program from a
    seed and calls back each iteration."""
    add = lambda v: (lambda gen, s: s + [v])
    assert Cycle([add(1), add(2)], repeats=2)(None, []) == [1, 2, 1, 2]
    assert Repeat(add(3), 3)(None, []) == [3, 3, 3]
    gen = torch.Generator().manual_seed(0)
    picks = [Mixture([add(0), add(1)], weights=[0.2, 0.8])(gen, [])[0] for _ in range(400)]
    assert 0.7 < np.mean(picks) < 0.9
    seen = []
    out = run_inference(0, [], Cycle([add(1)]), 4, callback=lambda it, s: seen.append(it),
                        device="cpu")
    assert out == [1, 1, 1, 1] and seen == [0, 1, 2, 3]


def test_gibbs_dispatch_refuses_cpu_tensors(ref_setup, monkeypatch):
    """``mode="always"`` on CPU tensors raises instead of running the plain
    sweep, and the serving workload, asked for the card where there is none,
    raises instead of falling back to the CPU."""
    cfg_j, data_j, state_j = ref_setup
    st, data = _port_state(jax.tree.map(lambda a: a[None], state_j)), _port_data(data_j)
    pts = torch.arange(3, dtype=torch.int32)[None]
    nrm, u = torch.zeros(1, 3, 3), torch.zeros(1, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.gibbs_z_sweep(data.x, data.y, st.z, st.w, torch.log(st.alpha), st.stats, pts, nrm, u,
                          _port_cfg(cfg_j).niw_prior("cpu"), 1.0, mode="always")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jointdpm.make_serving_workload(smoke=True, n=100)
