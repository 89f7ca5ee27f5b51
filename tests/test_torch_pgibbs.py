"""The port's particle-Gibbs sweep (plain version on the CPU) and its SMC
module, against exact answers and against the JAX package in distribution.

The sweep draws its random numbers from a ``torch.Generator`` and the
reference from JAX keys, so the two are compared as samplers: the retained
path is kept exactly when there is one particle, the sampled paths match a
quadrature posterior mean at T = 1, and the port's sweep and the JAX fast
sweep agree in the cross-sweep mean of |h| (the bar of
``tests/test_pgibbs_fused.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.experiments import stochvol as jsv
from repro.kernels.pgibbs import batched_pgibbs_sweep as j_sweep
from repro_torch import convert
from repro_torch.experiments import stochvol
from repro_torch.inference import csmc, particle_filter
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pgibbs import (
    batched_pgibbs_sweep,
    draw_sweep_randomness,
    pgibbs_sweep_fused,
    pgibbs_sweep_ref,
)

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _quadrature(x, s2, fn):
    """E[fn(h) | x] under h ~ N(0, s2), x ~ N(0, exp(h)), on a fine grid;
    with fn=None the evidence p(x)."""
    h = np.linspace(-12, 12, 200_001)
    logp = -0.5 * h * h / s2 - 0.5 * np.log(2 * np.pi * s2) - 0.5 * (
        x * x * np.exp(-h) + h + np.log(2 * np.pi))
    w = np.exp(logp - logp.max())
    if fn is None:
        return float(np.log(np.trapezoid(w, h)) + logp.max())
    return float(np.trapezoid(w * fn(h), h) / np.trapezoid(w, h))


def test_one_particle_keeps_the_retained_path():
    rng = np.random.default_rng(0)
    k, s, t = 3, 7, 6
    obs = torch.tensor(rng.standard_normal((s, t)).astype(np.float32))
    h = torch.tensor(rng.standard_normal((k, s, t)).astype(np.float32))
    phi, s2 = torch.full((k,), 0.9), torch.full((k,), 0.02)
    out = batched_pgibbs_sweep(_gen(1), obs, h, phi, s2, num_particles=1)
    assert torch.equal(out, h)
    assert torch.equal(pgibbs_sweep_fused(_gen(1), obs, h[0], phi[0], s2[0], num_particles=1),
                       h[0])
    params = stochvol.SVParams(phi[0], s2[0])
    path = stochvol.pgibbs_sweep(_gen(2), obs, h[0], params, num_particles=1)
    assert torch.equal(path, h[0])


def test_single_chain_wrapper_is_the_k1_batch():
    rng = np.random.default_rng(1)
    obs = torch.tensor(rng.standard_normal((5, 4)).astype(np.float32))
    h = torch.tensor(0.1 * rng.standard_normal((5, 4)).astype(np.float32))
    a = pgibbs_sweep_fused(_gen(3), obs, h, torch.tensor(0.9), torch.tensor(0.05), num_particles=6)
    b = batched_pgibbs_sweep(_gen(3), obs, h[None], torch.tensor([0.9]), torch.tensor([0.05]),
                             num_particles=6)[0]
    assert torch.equal(a, b)
    # the random numbers come from the generator in a fixed order
    noise, u, u_pick = draw_sweep_randomness(_gen(3), 1, 5, 4, 6, "cpu")
    direct = ops.pgibbs_sweep(noise, u, u_pick, obs, h[None], torch.tensor([0.9]),
                                      torch.tensor([0.05]))
    assert torch.equal(direct[0], a)


@pytest.mark.parametrize("sweep", ["fused", "opaque"])
def test_t1_posterior_mean_matches_quadrature(sweep):
    """T = 1: each series' h has prior N(0, s2) and one observation x. The
    sweep is a Markov kernel that leaves p(h | x) invariant; averaged over
    sweeps 5..19 and over independent series, the sampled h's mean matches
    the quadrature posterior mean within 4 Monte Carlo standard errors
    (the standard error from the spread of the per-series means)."""
    x, s2, p = 2.0, 0.5, 8
    k, s, sweeps = (4, 400, 20) if sweep == "fused" else (1, 60, 20)
    obs = torch.full((s, 1), x)
    h = torch.zeros((k, s, 1))
    phi, s2t = torch.full((k,), 0.9), torch.full((k,), s2)
    gen, draws = _gen(4), []
    for i in range(sweeps):
        if sweep == "fused":
            h = batched_pgibbs_sweep(gen, obs, h, phi, s2t, num_particles=p)
        else:
            h = stochvol.pgibbs_sweep(gen, obs, h[0], stochvol.SVParams(phi[0], s2t[0]), p)[None]
        if i >= 5:
            draws.append(h[..., 0].numpy().reshape(-1))
    per_series = np.mean(draws, axis=0)
    se = per_series.std(ddof=1) / np.sqrt(per_series.size)
    want = _quadrature(x, s2, lambda v: v)
    assert abs(per_series.mean() - want) <= 4 * se, (per_series.mean(), want, se)


def test_fast_sweep_agrees_with_jax_in_distribution():
    """Cross-sweep mean |h| of the port's sweep against the JAX fast sweep
    on the JAX package's data, within 25% (tests/test_pgibbs_fused.py)."""
    data = jsv.synth(jax.random.key(3), num_series=50, length=6)
    k, p = 16, 24
    obs = torch.tensor(np.asarray(data.obs))
    means = {}
    h, acc = jnp.zeros((k,) + data.obs.shape), []
    for i in range(6):
        h = j_sweep(jax.random.split(jax.random.key(100 + i), k), data.obs, h,
                    jnp.full((k,), 0.95), jnp.full((k,), 0.01), num_particles=p, mode="fast")
        if i >= 2:
            acc.append(np.asarray(h))
    means["jax"] = float(np.mean(np.abs(np.stack(acc))))
    gen, th, acc = _gen(5), torch.zeros((k,) + tuple(obs.shape)), []
    for i in range(6):
        th = batched_pgibbs_sweep(gen, obs, th, torch.full((k,), 0.95), torch.full((k,), 0.01),
                                  num_particles=p)
        if i >= 2:
            acc.append(th.numpy())
    means["port"] = float(np.mean(np.abs(np.stack(acc))))
    assert means["port"] == pytest.approx(means["jax"], rel=0.25)


def test_particle_filter_evidence_at_t1():
    """The bootstrap filter's evidence estimate at T = 1 with many particles
    is the log of a mean of prior-weighted likelihoods: within 0.05 of the
    quadrature log p(x)."""
    x, s2 = 1.5, 0.3
    sample = lambda g, hp, t, prm: ref.ar1_propagate(
        hp, torch.randn(hp.shape, generator=g), prm.phi, prm.sigma2)
    weight = lambda xt, ht, t, prm: ref.sv_obs_loglik(xt, ht)
    params = stochvol.SVParams(torch.tensor(0.9), torch.tensor(s2))
    res = particle_filter(_gen(6), torch.tensor([x]), params, sample, weight, 20_000)
    assert res.trajectory.shape == (1,)
    assert abs(float(res.log_evidence) - _quadrature(x, s2, None)) < 0.05
    res = csmc(_gen(7), torch.tensor([x, -x]), torch.zeros(2), params, sample, weight, 50)
    assert res.trajectory.shape == (2,) and bool(torch.isfinite(res.log_evidence))


def test_sweep_plain_version_shapes_and_compat():
    rng = np.random.default_rng(2)
    k, s, t, p = 2, 10, 5, 6
    obs = torch.tensor(rng.standard_normal((s, t)).astype(np.float32))
    h = torch.tensor(0.1 * rng.standard_normal((k, s, t)).astype(np.float32))
    phi, s2 = torch.full((k,), 0.95), torch.full((k,), 0.01)
    noise, u, u_pick = draw_sweep_randomness(_gen(8), k, s, t, p, "cpu")
    out = pgibbs_sweep_ref(noise, u, u_pick, obs, h, phi, s2)
    assert out.shape == (k, s, t) and bool(torch.isfinite(out).all())
    with pytest.raises(NotImplementedError, match="threefry"):
        batched_pgibbs_sweep(_gen(0), obs, h, phi, s2, num_particles=p, mode="compat")
    with pytest.raises(ValueError):
        batched_pgibbs_sweep(_gen(0), obs, h, phi, s2, num_particles=p, mode="slow")
    data = convert.sv_data(np.asarray(obs), np.asarray(h[0]), device="cpu")
    lp = stochvol.exact_state_loglik(data.obs, data.h_true, stochvol.SVParams(0.95, 0.01))
    jlp = jsv.exact_state_loglik(jnp.asarray(obs.numpy()), jnp.asarray(h[0].numpy()),
                                 jsv.SVParams(jnp.asarray(0.95), jnp.asarray(0.01)))
    assert math.isclose(float(lp), float(jlp), rel_tol=1e-5)


def _lane_order_cdf(e: np.ndarray) -> np.ndarray:
    """The sweep kernel's resampling CDF for one series, written lane by lane
    in float32: particle i = g + G r on lane g of G lanes (G the smallest
    power of two >= P, at most 32); each lane sums its particles, an xor
    butterfly sums the lanes, each chunk r of G particles is scanned across
    the lanes (Hillis-Steele) and offset by the chunks before."""
    f32 = np.float32
    p = e.size
    g_n = 1
    while g_n < min(p, 32):
        g_n *= 2
    r_n = -(-p // g_n)
    val = lambda g, r: e[g + g_n * r] if g + g_n * r < p else f32(0)
    tot = [f32(0)] * g_n
    for g in range(g_n):
        for r in range(r_n):
            tot[g] = f32(tot[g] + val(g, r))
    off = g_n // 2
    while off:
        tot = [f32(tot[g] + tot[g ^ off]) for g in range(g_n)]
        off //= 2
    cdf, carry = np.zeros(p, np.float32), f32(0)
    for r in range(r_n):
        v = [f32(val(g, r) / tot[g]) for g in range(g_n)]
        off = 1
        while off < g_n:
            v = [f32(v[g] + v[g - off]) if g >= off else v[g] for g in range(g_n)]
            off *= 2
        for g in range(g_n):
            if g + g_n * r < p:
                cdf[g + g_n * r] = f32(carry + v[g])
        carry = f32(carry + v[g_n - 1])
    return cdf


@pytest.mark.parametrize("p", [1, 3, 16, 25, 32, 33, 100, 256])
def test_plain_resampling_cdf_follows_the_kernel_order(p):
    """The plain sweep's CDF adds in the kernel's order (so the two resample
    alike on the card): bit for bit the lane-by-lane transcription above,
    given the same exponentials, and within rounding of a plain cumsum."""
    from repro_torch.kernels.ref import lane_order_cdf

    rng = np.random.default_rng(p)
    for _ in range(5):
        logw = torch.tensor((3.0 * rng.standard_normal((1, p))).astype(np.float32))
        got = lane_order_cdf(logw)[0].numpy()
        e = torch.exp(logw - logw.amax(-1, keepdim=True))[0].numpy()
        np.testing.assert_array_equal(got, _lane_order_cdf(e))
        np.testing.assert_allclose(got, np.cumsum(e / e.sum()), rtol=0, atol=1e-6)
        assert np.all(np.diff(got) >= 0)
