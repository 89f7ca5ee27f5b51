"""The BayesLR slice end to end: the port's experiment module and chains
against the JAX package's, on data made with numpy and carried across by
:mod:`repro_torch.convert`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.experiments import bayeslr as jbayeslr
from repro_torch import convert
from repro_torch.core import (
    ChainEnsemble,
    RandomWalk,
    SubsampledMHConfig,
    acceptance_rate,
    effective_sample_size,
    make_kernel,
    run_chain,
    run_chain_timed,
)
from repro_torch.experiments import bayeslr

torch.set_num_threads(1)


def _lr_numpy(n, d, seed=0):
    rng = np.random.default_rng(seed)
    scales = 1.0 / np.sqrt(1.0 + np.arange(d))
    w_true = (2.0 * rng.standard_normal(d) * scales).astype(np.float32)
    x = (rng.standard_normal((n, d)) * scales).astype(np.float32)
    y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-x @ w_true)), 1.0, -1.0).astype(np.float32)
    return x, y, w_true


def test_make_target_matches_jax():
    x, y, w_true = _lr_numpy(300, 6)
    jt = jbayeslr.make_target(jnp.asarray(x), jnp.asarray(y))
    data = convert.lr_data(x, y, x[:20], y[:20], w_true, device="cpu")
    tt = bayeslr.make_target(data.x_train, data.y_train)
    rng = np.random.default_rng(1)
    w, wp = (rng.standard_normal(6).astype(np.float32) for _ in range(2))
    idx = rng.integers(0, 300, 50).astype(np.int32)
    np.testing.assert_allclose(
        tt.log_local(torch.from_numpy(w), torch.from_numpy(wp), torch.from_numpy(idx)).numpy(),
        np.asarray(jt.log_local(jnp.asarray(w), jnp.asarray(wp), jnp.asarray(idx))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tt.log_global(torch.from_numpy(w), torch.from_numpy(wp))),
                               float(jt.log_global(jnp.asarray(w), jnp.asarray(wp))), rtol=1e-5)
    np.testing.assert_allclose(float(tt.log_density(torch.from_numpy(w))),
                               float(jt.log_density(jnp.asarray(w))), rtol=1e-5)


def test_run_chain_posterior_matches_jax():
    """Posterior mean of a narrow BayesLR (N=2000, D=8) from the port's
    chain and the reference's agree within 4 combined Monte Carlo standard
    errors per dimension (ESS by Geyer's estimator), acceptance within 0.05."""
    n, d, steps, burn = 2000, 8, 600, 100
    x, y, w_true = _lr_numpy(n, d, seed=2)
    cfg = dict(batch_size=500, epsilon=0.05, sampler="stream")
    jt = jbayeslr.make_target(jnp.asarray(x), jnp.asarray(y))
    _, jsamples, jinfos = jax.jit(lambda k: J.run_chain(
        k, jnp.asarray(w_true), jt, J.RandomWalk(0.05), steps,
        config=J.SubsampledMHConfig(**cfg)))(jax.random.key(0))
    data = convert.lr_data(x, y, device="cpu")
    tt = bayeslr.make_target(data.x_train, data.y_train)
    _, tsamples, tinfos = run_chain(0, torch.from_numpy(w_true), tt, RandomWalk(0.05), steps,
                                    config=SubsampledMHConfig(**cfg), device="cpu")
    js, ts = np.asarray(jsamples)[burn:], tsamples.numpy()[burn:]
    for k in range(d):
        se2 = sum(np.var(c[:, k]) / effective_sample_size(c[:, k]) for c in (js, ts))
        assert abs(js[:, k].mean() - ts[:, k].mean()) <= 4 * np.sqrt(se2), k
    assert abs(acceptance_rate(tinfos) - float(np.mean(np.asarray(jinfos.accepted)))) <= 0.05


def test_run_posterior_ensemble_on_cpu():
    data = bayeslr.synth_mnist_like(0, n_train=500, n_test=50, d=4, device="cpu")
    samples, diag = bayeslr.run_posterior_ensemble(1, data, num_chains=3, num_steps=20,
                                                   batch_size=50, device="cpu")
    assert samples.shape == (3, 20, 4) and np.isfinite(samples).all()
    assert diag["rhat"].shape == (4,) and diag["accept_rate"].shape == (3,)
    assert 0 < diag["mean_n_evaluated_overall"] <= 500
    assert diag["ess_w0"] > 0 and diag["rounds_tail"]["max"] >= 1


def test_synth_data_shapes_and_seeds():
    a = bayeslr.synth_mnist_like(3, n_train=100, n_test=20, d=5, device="cpu")
    b = bayeslr.synth_mnist_like(3, n_train=100, n_test=20, d=5, device="cpu")
    assert a.x_train.shape == (100, 5) and a.x_test.shape == (20, 5)
    assert torch.equal(a.x_train, b.x_train) and torch.equal(a.y_test, b.y_test)
    assert set(torch.unique(a.y_train).tolist()) <= {-1.0, 1.0}
    s = bayeslr.synth_2d(0, 1000, device="cpu")
    assert s.x_train.shape == (1000, 2) and s.x_test.shape == (100, 2)
    # the features carry signal: w_true classifies far better than chance
    assert bayeslr.test_error(a.w_true, a.x_train, a.y_train) < 0.4


def test_predictive_helpers_match_jax():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((30, 3))
    xt = rng.standard_normal((10, 3))
    yt = np.sign(rng.standard_normal(10))
    got = bayeslr.predictive_mean_prob(torch.from_numpy(w), torch.from_numpy(xt))
    want = jbayeslr.predictive_mean_prob(w, xt)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(bayeslr.risk_vs_reference(got, want[-1]),
                               jbayeslr.risk_vs_reference(want, want[-1]), rtol=1e-12)
    assert bayeslr.test_error(w[0], xt, yt) == jbayeslr.test_error(w[0], xt, yt)


def test_convert_carries_sampler_state():
    x, y, _ = _lr_numpy(40, 3)
    theta = np.zeros((2, 3), np.float32)
    st = convert.ensemble_state(theta, "stream", 40, pos=np.array([0, 10], np.int32), device="cpu")
    assert st.theta.shape == (2, 3) and st.sampler_state.pos.tolist() == [0, 10]
    jfy = jax.vmap(lambda _: J.fy_init(40))(jnp.arange(2))
    st = convert.ensemble_state(theta, "fy", 40, idx=np.asarray(jfy.idx), pos=np.asarray(jfy.pos),
                                size=np.asarray(jfy.size), device="cpu")
    assert st.sampler_state.idx.shape == (2, 40) and st.sampler_state.idx.dtype == torch.int32
    tt = bayeslr.make_target(*convert.lr_data(x, y, device="cpu")[:2])
    ens = ChainEnsemble(tt, RandomWalk(0.1), 2, config=SubsampledMHConfig(batch_size=10),
                        device="cpu")
    state, samples, infos = ens.run(0, st, 3)
    assert samples.shape == (2, 3, 3) and infos.n_evaluated.shape == (2, 3)
    with pytest.raises(ValueError):
        convert.sampler_state("fy", 40, pos=0, device="cpu")


def test_fig5_fraction_falls_with_n():
    """Paper Fig. 5 at CPU size: at fixed theta the evaluated fraction of
    the data falls as N grows (the card runs N up to 1e6)."""
    fracs = []
    for n in (1000, 10_000):
        data = bayeslr.synth_2d(0, n, device="cpu")
        target = bayeslr.make_target(data.x_train, data.y_train)
        state0, step = make_kernel(target, RandomWalk(0.1),
                                   SubsampledMHConfig(batch_size=100, epsilon=0.01, sampler="stream"))
        gen = torch.Generator().manual_seed(100)
        theta = torch.tensor([1.6, -1.6])
        evals = [int(step(gen, theta, state0)[2].n_evaluated) for _ in range(15)]
        fracs.append(np.mean(evals) / n)
    assert fracs[1] < fracs[0]


def test_run_chain_timed_and_exact_kernel():
    x, y, w_true = _lr_numpy(200, 3)
    tt = bayeslr.make_target(*convert.lr_data(x, y, device="cpu")[:2])
    out = run_chain_timed(0, torch.from_numpy(w_true), tt, RandomWalk(0.05), 4,
                          config=SubsampledMHConfig(batch_size=50), device="cpu")
    assert len(out["samples"]) == 4 and out["times"][0] == 0.0
    _, samples, infos = run_chain(0, torch.from_numpy(w_true), tt, RandomWalk(0.05), 5,
                                  kernel="exact", chunk_size=64, device="cpu")
    assert samples.shape == (5, 3) and bool((infos.n_evaluated == 200).all())
    ens = ChainEnsemble(tt, RandomWalk(0.05), 2, kernel="exact", chunk_size=64, device="cpu")
    _, es, ei = ens.run(0, ens.init(torch.from_numpy(w_true)), 3)
    assert es.shape == (2, 3, 3) and bool((ei.rounds == 4).all())
    state, timed = ens.run_timed(1, ens.init(torch.from_numpy(w_true)), 4, block_every=3)
    assert timed["samples"].shape == (2, 4, 3) and timed["transitions_per_sec"] > 0


# ---------------------------------------------------------------------------
# MALA and the log-posterior gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("subsample", [None, 100])
def test_make_grad_fn_matches_jax_grad(subsample):
    """The autograd gradient of the log posterior (or of its first-100-rows
    estimate rescaled by N/100) against jax.grad of the reference's, for
    one chain and a (K, D) batch: within 1e-5 of the largest component
    (float32 sums over N rows in another order)."""
    x, y, _ = _lr_numpy(500, 6, seed=3)
    w = np.random.default_rng(4).normal(0, 0.5, (3, 6)).astype(np.float32)
    jgrad = jbayeslr.make_grad_fn(jnp.asarray(x), jnp.asarray(y), subsample=subsample)
    want = np.stack([np.asarray(jgrad(jnp.asarray(wi))) for wi in w])
    tgrad = bayeslr.make_grad_fn(torch.from_numpy(x), torch.from_numpy(y), subsample=subsample)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(tgrad(torch.from_numpy(w)).numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(tgrad(torch.from_numpy(w[1])).numpy(), want[1], rtol=0, atol=tol)


def test_mala_matches_jax_formula(monkeypatch):
    """Given the same xi and the same gradient function, theta' equals the
    reference's bit for bit (the same float32 operations), for one chain and
    for a (K, D) batch. The q-correction (per chain in the batch) is the
    difference of two log q terms of size ~D/2 = 3.5, each a sum over D in
    another order: it agrees within 2e-6, a few float32 ulps of those
    terms."""
    from repro.core import proposals as jproposals
    from repro_torch.core import MALA, proposals

    rng = np.random.default_rng(5)
    theta = rng.normal(0, 1, (4, 7)).astype(np.float32)
    xi = rng.standard_normal((4, 7)).astype(np.float32)
    step = 3e-3
    jgrad = lambda th: -2.0 * th + 0.5 * jnp.tanh(th)
    tgrad = lambda th: -2.0 * th + 0.5 * torch.tanh(th)
    key = jax.random.key(0)
    monkeypatch.setattr(jproposals, "_tree_randn_like", lambda k, t: jnp.asarray(xi[row]))
    for row in range(4):
        jp, jc = J.MALA(step, jgrad)(key, jnp.asarray(theta[row]))
        monkeypatch.setattr(proposals, "_randn_like", lambda g, t: torch.from_numpy(xi[row]))
        tp, tc = MALA(step, tgrad)(None, torch.from_numpy(theta[row]))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(float(tc), float(jc), rtol=0, atol=2e-6)
        monkeypatch.setattr(proposals, "_randn_like", lambda g, t: torch.from_numpy(xi))
        bp, bc = MALA(step, tgrad)(None, torch.from_numpy(theta), batch_ndim=1)
        assert bc.shape == (4,)
        np.testing.assert_array_equal(bp[row].numpy(), np.asarray(jp))
        np.testing.assert_allclose(float(bc[row]), float(jc), rtol=0, atol=2e-6)


def test_mala_correction_is_per_chain_for_any_leaf_rank(monkeypatch):
    """Through ``propose`` and ``propose_and_mu0`` with K chains, MALA's
    correction is (K,) and each chain's equals the reference's one-chain
    correction (within 2e-6, as above), whatever the rank of the leaves:
    scalar chains (theta (K,)) and a tree whose leaves are (K,) and
    (K, 3)."""
    from repro.core import proposals as jproposals
    from repro_torch.core import MALA, proposals, propose_and_mu0

    rng = np.random.default_rng(8)
    k, step = 5, 3e-2
    trees = {
        "scalar": {"a": rng.normal(0, 1, (k,))},
        "mixed": {"a": rng.normal(0, 1, (k,)), "b": rng.normal(0, 1, (k, 3))},
    }
    jgrad = lambda th: {n: -1.5 * l + 0.3 * jnp.sin(l) for n, l in th.items()}
    tgrad = lambda th: {n: -1.5 * l + 0.3 * torch.sin(l) for n, l in th.items()}
    target = bayeslr.make_target(*(torch.from_numpy(a) for a in _lr_numpy(50, 2)[:2]))
    target = dataclasses.replace(target, log_global=lambda a, b: torch.zeros((), dtype=torch.float32))
    for name, theta in trees.items():
        theta = {n: l.astype(np.float32) for n, l in theta.items()}
        xi = {n: rng.standard_normal(l.shape).astype(np.float32) for n, l in theta.items()}
        monkeypatch.setattr(proposals, "_randn_like", lambda g, t: {
            n: torch.from_numpy(v) for n, v in xi.items()})
        tt = {n: torch.from_numpy(l) for n, l in theta.items()}
        _, corr = proposals.propose(MALA(step, tgrad), None, tt, batch_ndim=1)
        _, mu0, log_u = propose_and_mu0(torch.Generator().manual_seed(0), tt, target,
                                        MALA(step, tgrad), batch_shape=(k,))
        assert corr.shape == (k,) and mu0.shape == (k,), name
        torch.testing.assert_close(mu0, (log_u - corr) / target.num_sections, rtol=0, atol=0)
        for row in range(k):
            monkeypatch.setattr(jproposals, "_tree_randn_like", lambda key, t: {
                n: jnp.asarray(v[row]) for n, v in xi.items()})
            _, jc = J.MALA(step, jgrad)(jax.random.key(0),
                                        {n: jnp.asarray(l[row]) for n, l in theta.items()})
            np.testing.assert_allclose(float(corr[row]), float(jc), rtol=0, atol=2e-6,
                                       err_msg=f"{name} chain {row}")


def test_mala_chain_stays_finite():
    """The reference's test_bayeslr_mala_proposal_runs in the port: 100
    subsampled transitions with MALA(1e-4) on the subsampled gradient stay
    finite; so do 20 steps of a 3-chain masked ensemble."""
    from repro_torch.core import MALA

    x, y, w_true = _lr_numpy(500, 2, seed=6)
    data = convert.lr_data(x, y, x[:50], y[:50], w_true, device="cpu")
    target = bayeslr.make_target(data.x_train, data.y_train)
    mala = MALA(1e-4, bayeslr.make_grad_fn(data.x_train, data.y_train, subsample=100))
    cfg = SubsampledMHConfig(batch_size=100, epsilon=0.05)
    _, samples, infos = run_chain(5, torch.zeros(2), target, mala, 100, config=cfg, device="cpu")
    assert bool(torch.isfinite(samples).all()) and 0 < acceptance_rate(infos) <= 1
    ens = ChainEnsemble(target, mala, 3, config=cfg, stepping="masked", device="cpu")
    _, samples, infos = ens.run(5, ens.init(torch.zeros(2)), 20)
    assert samples.shape == (3, 20, 2) and bool(torch.isfinite(samples).all())
