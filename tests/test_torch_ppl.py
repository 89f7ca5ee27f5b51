"""The port's PET layer (``repro_torch.ppl``) against the JAX package's.

Each program is built twice, once per package, from the same numpy arrays,
and both get the same numpy thetas. On the CPU the port's wrappers take
their plain versions, so the compiled family routes are held here to the
graph and to the reference; ``tests/test_torch_cuda.py`` holds the kernels.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ppl as JP
import repro_torch.ppl as TP
from repro.ppl.trace import partition as j_partition
from repro_torch.core import ChainEnsemble, RandomWalk, SubsampledMHConfig, run_chain
from repro_torch.experiments import bayeslr

torch.set_num_threads(1)

F32 = np.float32
# (dists module, array namespace, numpy -> array, new trace) of each package
PKGS = {"jax": (JP, jnp, jnp.asarray, JP.Trace),
        "torch": (TP, torch, torch.tensor, lambda: TP.Trace(device="cpu"))}
GATES = {"logit": "logit", "clipped_logit": None, "non_logit": None,
         "ar1": "gaussian_ar1", "tanh_ar1": None, "plate_scale_ar1": None}


def _fig1(pkg, existential=False):
    """Fig. 1: [assume b (bernoulli 0.5)] [assume mu (if b 1 (gamma 1 1))]
    [assume y (normal mu 0.1)] [observe y 10.0] with b = True; or b with an
    existential child g (Def. 3)."""
    P, lib, arr, new = PKGS[pkg]
    tr = new()
    b = tr.sample("b", P.dists.bernoulli, tr.constant("p", 0.5), value=arr(F32(1.0)))
    if existential:
        tr.sample("g", P.dists.gamma, tr.constant("a", 1.0), tr.constant("r", 1.0),
                  value=arr(F32(0.7)), exist_parent=b)
        return tr, {"b": b}
    mu = tr.det("mu", lambda bb: lib.where(bb > 0, 1.0, 0.0), b)
    y = tr.sample("y", P.dists.normal, mu, tr.constant("sig", 0.1), value=arr(F32(10.0)))
    tr.observe(y, arr(F32(10.0)))
    return tr, {"b": b, "y": y}


def _program(name, pkg, n=200):
    """The programs of ``tests/test_ppl.py`` (BayesLR and its clipped
    variant, a conjugate-normal plate, AR(1) and its tanh and
    plate-varying-scale variants), on numpy data made from seed 0.
    Returns (trace, target variable)."""
    P, lib, arr, new = PKGS[pkg]
    rng = np.random.default_rng(0)
    tr = new()
    if name in ("logit", "clipped_logit"):
        d = 3
        x = rng.standard_normal((n, d)).astype(F32)
        p = 1.0 / (1.0 + np.exp(-x @ np.linspace(-1.0, 1.0, d)))
        y = np.where(rng.uniform(size=n) < p, 1.0, -1.0).astype(F32)
        w = tr.sample("w", P.dists.mvnormal_diag, tr.constant("mu_w", arr(np.zeros(d, F32))),
                      tr.constant("sig_w", arr(np.full(d, np.sqrt(0.1), F32))),
                      value=arr(np.zeros(d, F32)))
        fn = (lambda xx, ww: xx @ ww) if name == "logit" else (
            lambda xx, ww: lib.clip(xx @ ww, -15.0, 15.0))
        with tr.plate("data", n):
            z = tr.det("z", fn, tr.constant("x", arr(x)), w)
            tr.observe(tr.sample("y", P.dists.bernoulli_logits, z, value=arr(y)), arr(y))
        return tr, w
    if name == "non_logit":
        x = (0.5 + rng.standard_normal(n)).astype(F32)
        mu = tr.sample("mu", P.dists.normal, tr.constant("m0", 0.0), tr.constant("s0", 1.0),
                       value=arr(F32(0.2)))
        sig = tr.constant("sig", 1.0)
        with tr.plate("data", n):
            tr.observe(tr.sample("y", P.dists.normal, mu, sig, value=arr(x)), arr(x))
        return tr, mu
    series = np.zeros(n + 1, F32)
    for t in range(1, n + 1):
        series[t] = 0.8 * series[t - 1] + 0.3 * rng.standard_normal()
    phi = tr.sample("phi", P.dists.normal, tr.constant("m0", 0.0), tr.constant("s0", 1.0),
                    value=arr(F32(0.5)))
    sig = tr.constant("sigma", 0.3)
    fn = (lambda xp, ph: lib.tanh(ph * xp)) if name == "tanh_ar1" else (lambda xp, ph: ph * xp)
    with tr.plate("steps", n):
        mu = tr.det("mu", fn, tr.constant("x_prev", arr(series[:-1])), phi)
        if name == "plate_scale_ar1":
            sig = tr.constant("sigma_t", arr(np.linspace(0.1, 0.5, n).astype(F32)))
        tr.observe(tr.sample("x", P.dists.normal, mu, sig, value=arr(series[1:])),
                   arr(series[1:]))
    return tr, phi


def _compiled(name, pkg, n=200):
    tr, v = _program(name, pkg, n)
    return PKGS[pkg][0].compile_partitioned_target(tr, v)


def _names(nodes):
    return {n.name for n in nodes}


@pytest.mark.parametrize("var", ["b", "y"])
def test_fig1_scaffold_sets_match_reference(var):
    sets = {}
    for pkg in PKGS:
        tr, nodes = _fig1(pkg)
        sc = PKGS[pkg][0].scaffold(tr, nodes[var])
        sets[pkg] = (_names(sc.D), _names(sc.T), _names(sc.A))
    assert sets["torch"] == sets["jax"]
    want = ({"b", "mu"}, set(), {"y"}) if var == "b" else ({"y"}, set(), set())
    assert sets["torch"] == want


def test_existential_edge_makes_transient_set_and_partition_refuses():
    tr, nodes = _fig1("torch", existential=True)
    sc = TP.scaffold(tr, nodes["b"])
    assert _names(sc.T) == {"g"}
    with pytest.raises(ValueError, match="T\\(rho, v\\)"):
        TP.partition(tr, sc)
    jtr, jnodes = _fig1("jax", existential=True)
    with pytest.raises(ValueError):
        j_partition(jtr, JP.scaffold(jtr, jnodes["b"]))


def test_bayeslr_border_node_is_w():
    tr, w = _program("logit", "torch")
    sc = TP.scaffold(tr, w)
    assert TP.border_node(tr, sc) is w
    assert _names(sc.D) == {"w", "z"} and _names(sc.A) == {"y"} and not sc.T


# Densities on a grid. fp32 distributions: 1e-6 relative. The lgamma users
# add 1e-5 absolute: XLA's CPU lgamma and the port's Lanczos form (XLA's
# operation order on the GPU) differ by up to 8 float32 ulps of
# 1 + |lgamma(a)|, most near lgamma's roots at 1 and 2, where the value is
# near 0; the grid's lgamma terms stay under 11.
_LGAMMA_USERS = ("gamma", "inv_gamma", "beta")


def _grid(name):
    lin = lambda a, b, k=40: np.linspace(a, b, k, dtype=F32)
    one = lambda *v: np.asarray(v, F32)
    return {
        "normal": (lin(-3, 3, 41), one(0.3), one(1.7)),
        "bernoulli": (np.tile(one(0, 1), 20), lin(0.01, 0.99)),
        "bernoulli_logits": (np.tile(one(-1, 1), 20), lin(-30, 30)),
        "gamma": (lin(0.05, 6), lin(0.3, 9), one(1.3)),
        "inv_gamma": (lin(0.05, 6), lin(0.3, 9), one(0.8)),
        "beta": (lin(0.02, 0.98), lin(0.3, 9), lin(5, 0.4)),
        "mvnormal_diag": (np.random.default_rng(0).standard_normal((7, 3)).astype(F32),
                          one(0.1, -0.2, 0.3), one(0.5, 1.0, 2.0)),
        "uniform": (lin(-1, 3, 41), one(0.0), one(2.0)),
    }[name]


@pytest.mark.parametrize("name", ["normal", "bernoulli", "bernoulli_logits", "gamma",
                                  "inv_gamma", "beta", "mvnormal_diag", "uniform"])
def test_logpdf_matches_reference(name):
    args = _grid(name)
    want = np.asarray(getattr(JP.dists, name).logpdf(*map(jnp.asarray, args)))
    got = getattr(TP.dists, name).logpdf(*map(torch.tensor, args))
    assert got.dtype == torch.float32
    atol = 1e-5 if name in _LGAMMA_USERS else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol)


# (params, mean, variance) of each distribution's draws
_MOMENTS = {
    "normal": ((0.3, 1.7), 0.3, 1.7 ** 2),
    "bernoulli": ((0.3,), 0.3, 0.21),
    "bernoulli_logits": ((0.5,), np.tanh(0.25), 1 - np.tanh(0.25) ** 2),
    "gamma": ((2.5, 1.3), 2.5 / 1.3, 2.5 / 1.3 ** 2),
    "inv_gamma": ((6.0, 0.8), 0.8 / 5, 0.8 ** 2 / (25 * 4)),
    "beta": ((2.0, 3.5), 2 / 5.5, 7 / (5.5 ** 2 * 6.5)),
    "mvnormal_diag": ((torch.tensor([0.1, -0.2]), torch.tensor([0.5, 2.0])),
                      np.array([0.1, -0.2]), np.array([0.25, 4.0])),
    "uniform": ((0.0, 2.0), 1.0, 1 / 3),
}


@pytest.mark.parametrize("name", sorted(_MOMENTS))
def test_sample_moments(name):
    """200 000 draws: the mean within 5 standard errors, the variance
    within 5% (inv_gamma's a = 6 keeps its fourth moment finite)."""
    params, mean, var = _MOMENTS[name]
    n = 200_000
    gen = torch.Generator().manual_seed(11)
    s = getattr(TP.dists, name).sample(gen, *params, shape=(n,)).double().numpy()
    assert s.shape[0] == n and np.isfinite(s).all()
    assert np.all(np.abs(s.mean(0) - mean) < 5 * np.sqrt(var / n)), (s.mean(0), mean)
    np.testing.assert_allclose(s.var(0), var, rtol=0.05)


@pytest.mark.parametrize("name", ["logit", "ar1"])
def test_compiled_program_matches_reference(name):
    """Same family; log_global, log_local and log_density within rtol 1e-5
    / atol 1e-6 of the reference on the same thetas."""
    n = 200
    tj, tt = _compiled(name, "jax", n), _compiled(name, "torch", n)
    assert tt.family == tj.family == GATES[name]
    assert tt.num_sections == tj.num_sections == n
    rng = np.random.default_rng(2)
    shape = (3,) if name == "logit" else ()
    t1 = (0.3 * rng.standard_normal(shape)).astype(F32)
    t2 = (t1 + 0.1 * rng.standard_normal(shape)).astype(F32)
    idx = rng.integers(0, n, 40).astype(np.int32)
    J, T = (lambda a: jnp.asarray(a)), (lambda a: torch.tensor(a))
    pairs = [(tt.log_global(T(t1), T(t2)), tj.log_global(J(t1), J(t2))),
             (tt.log_local(T(t1), T(t2), T(idx)), tj.log_local(J(t1), J(t2), J(idx))),
             (tt.log_density(T(t2)), tj.log_density(J(t2)))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_compiled_logit_ensemble_is_hand_built_targets_bit_for_bit():
    """The compiled program's (K, m) rounds are ``bayeslr.make_target``'s on
    the same tensors: one family delta, no graph in between."""
    tr, w = _program("logit", "torch", 250)
    compiled = TP.compile_partitioned_target(tr, w)
    x, y = tr.nodes[[n.name for n in tr.nodes].index("x")].value, tr.nodes[-1].value
    hand = bayeslr.make_target(x, y)
    gen = torch.Generator().manual_seed(2)
    wc, wp = torch.randn(4, 3, generator=gen), torch.randn(4, 3, generator=gen)
    idx = torch.randint(0, 250, (4, 40), generator=gen, dtype=torch.int32)
    assert torch.equal(compiled.log_local_ensemble(wc, wp, idx),
                       hand.log_local_ensemble(wc, wp, idx))
    torch.testing.assert_close(compiled.log_global(wc, wp), hand.log_global(wc, wp),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["logit", "ar1", "non_logit"])
def test_compiled_log_global_keeps_the_chain_axis(name):
    """(K, ...) thetas give (K,): each chain's own prior difference (and
    density), never one sum over the chains."""
    target = _compiled(name, "torch")
    k = 5
    gen = torch.Generator().manual_seed(3)
    shape = (k, 3) if name == "logit" else (k,)
    th = 0.3 * torch.randn(shape, generator=gen)
    thp = th + 0.1 * torch.randn(shape, generator=gen)
    lg = target.log_global(th, thp)
    assert lg.shape == (k,)
    torch.testing.assert_close(lg, torch.stack([target.log_global(th[i], thp[i])
                                                for i in range(k)]), rtol=1e-6, atol=1e-6)
    dens = target.log_density(th)
    assert dens.shape == (k,)
    torch.testing.assert_close(dens, torch.stack([target.log_density(th[i]) for i in range(k)]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(GATES))
def test_family_gates_decide_as_reference(name):
    tj, tt = _compiled(name, "jax"), _compiled(name, "torch")
    assert tt.family == tj.family == GATES[name]
    assert (tt.log_local_ensemble is None) == (tj.log_local_ensemble is None)


@pytest.mark.parametrize("name", ["logit", "ar1"])
def test_compiled_program_runs_chain_and_ensemble(name):
    """A compiled program through ``run_chain`` (the graph route) and a
    3-chain lock-step ensemble; on the CPU "auto" is "never", bit for bit."""
    target = _compiled(name, "torch", 300)
    theta0 = torch.zeros(3) if name == "logit" else torch.tensor(0.5)
    cfg = SubsampledMHConfig(batch_size=50, epsilon=0.05)
    _, samples, infos = run_chain(1, theta0, target, RandomWalk(0.05), 100, config=cfg,
                                  device="cpu")
    assert samples.shape == (100,) + tuple(theta0.shape)
    assert bool(torch.isfinite(samples).all())
    assert 0.0 < float(infos.accepted.float().mean()) < 1.0
    runs = {}
    for mode in ("auto", "never"):
        ens = ChainEnsemble(target, RandomWalk(0.05), 3, config=cfg, fused_kernels=mode,
                            device="cpu")
        _, s, i = ens.run(4, ens.init(theta0), 25)
        runs[mode] = (s, i.n_evaluated)
    assert all(torch.equal(a, b) for a, b in zip(runs["auto"], runs["never"]))


def test_trace_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TP.Trace().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.Trace()
    tr = TP.Trace(device="cpu")
    with tr.plate("data", 4) as plate:
        pass
    c = tr.constant("c", np.ones(2))
    assert plate.index_node.value.device.type == "cpu"
    assert c.value.dtype == torch.float32 and c.value.device.type == "cpu"


def test_ppl_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.ppl, repro_torch.ppl.compile, repro_torch.core.safeguard\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == ""
