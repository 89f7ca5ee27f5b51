"""The five ``examples/*_torch.py`` entry points on the CPU against the JAX
package's library calls on the same data.

Each example hands the library the reference example's settings, at the
smoke and the full size: the calls of both are recorded and compared field
by field (the run itself stopped or stubbed). Then each example's ``run``
takes the reference's data (made by the reference's own ``synth`` from
``jax.random.key(0)``, converted), at its smoke size or smaller. The two packages draw other random numbers (``torch.Generator``
against JAX keys), so each example's printed numbers are held to the
reference's library call at the same size in distribution, with the
tolerances stated in each test. The examples import neither ``jax`` nor
``repro``.
"""
import argparse
import dataclasses
import importlib.util
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "multichain", "dpmixture", "stochastic_volatility", "serve_lm")

torch.set_num_threads(1)


def _example(name, suffix="_torch"):
    path = os.path.join(HERE, "examples", f"{name}{suffix}.py")
    spec = importlib.util.spec_from_file_location(f"{name}{suffix}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.tensor(np.asarray(a))


def _quiet(*_a, **_k):
    pass


def test_examples_import_neither_jax_nor_reference():
    code = (
        "import importlib.util, os, sys\n"
        f"for name in {EXAMPLES!r}:\n"
        f"    path = os.path.join({HERE!r}, 'examples', name + '_torch.py')\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=env)
    assert out.stdout.strip() == ""


# ---------------------------------------------------------------------------
# the settings each example hands the library, against the reference example's
# ---------------------------------------------------------------------------


class _Stop(Exception):
    """Raised by a recorder in place of the run it records."""


def _fields(x):
    """A config's fields (a dataclass), a proposal's sigma, else ``x``."""
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return x


def _same_fields(a, b) -> bool:
    """Equal settings: for two configs, every field the two share (the
    port's may add device fields); otherwise plain equality."""
    fa, fb = _fields(a), _fields(b)
    if isinstance(fa, dict) and isinstance(fb, dict):
        common = set(fa) & set(fb)
        return bool(common) and all(fa[k] == fb[k] for k in common)
    return fa == fb


def _record(monkeypatch, owner, name, log, result=None, stop=False, through=False):
    """``owner.name`` replaced by a recorder that appends (positional
    arguments, keywords) to ``log`` and then raises :class:`_Stop`
    (``stop``), calls the real function (``through``) or returns
    ``result(*args, **kw)``."""
    real = getattr(owner, name)

    def rec(*args, **kw):
        log.append((args, kw))
        if stop:
            raise _Stop
        return real(*args, **kw) if through else result(*args, **kw)

    monkeypatch.setattr(owner, name, rec)


def _drop(kw, *names):
    return {k: v for k, v in kw.items() if k not in names}


def _quickstart_calls(monkeypatch, smoke):
    """(synth, safeguard, chain) calls of both quickstarts; each chain call
    returns zeros of its shapes, so the examples run on to their end."""
    from repro.experiments import bayeslr as jb
    from repro_torch.experiments import bayeslr as tb

    ref, port = _example("quickstart", ""), _example("quickstart")
    out = {}
    for side, mod, data, zeros in (("ref", ref, jb, jnp.zeros), ("port", port, tb, torch.zeros)):
        log = out[side] = {"synth": [], "trial": [], "chain": []}
        _record(monkeypatch, data, "synth_mnist_like", log["synth"], through=True)
        keys = ("num_trials", "jb_stat_mean", "jb_pvalue_min", "normal_ok",
                "decision_error_rate", "mean_fraction_evaluated")
        _record(monkeypatch, mod, "trial_run_report", log["trial"],
                result=lambda *a, **k: types.SimpleNamespace(**dict.fromkeys(keys, 0.0)))

        def chain(key, w0, target, prop, steps, zeros=zeros, **kw):
            infos = types.SimpleNamespace(accepted=zeros(steps), n_evaluated=zeros(steps) + 1)
            return None, zeros((steps,) + tuple(w0.shape)), infos

        _record(monkeypatch, mod, "run_chain", log["chain"], result=chain)
        if side == "ref":
            mod.main(smoke=smoke)
        else:
            mod.run(smoke=smoke, device="cpu", log=_quiet)
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_quickstart_passes_reference_settings(monkeypatch, smoke):
    """The port's quickstart hands the library what the reference's hands
    it: the data's sizes, the proposal's sigma and the safeguard's trials,
    then per kernel (exact, then subsampled) the steps, the kernel and
    every field of its config (m, epsilon, the sampler)."""
    got = _quickstart_calls(monkeypatch, smoke)
    ref, port = got["ref"], got["port"]
    assert _drop(ref["synth"][0][1]) == _drop(port["synth"][0][1], "device")
    (ra, rk), = ref["trial"]
    (pa, pk), = port["trial"]
    assert ra[3].sigma == pa[3].sigma and rk == pk
    assert len(ref["chain"]) == len(port["chain"]) == 2
    for (ra, rk), (pa, pk) in zip(ref["chain"], port["chain"]):
        assert ra[3].sigma == pa[3].sigma and ra[4] == pa[4]
        assert tuple(ra[1].shape) == tuple(pa[1].shape)
        assert rk["kernel"] == pk["kernel"]
        assert (rk["config"] is None) == (pk["config"] is None)
        if rk["config"] is not None:
            assert _same_fields(rk["config"], pk["config"])


def _stopped_run(monkeypatch, name, smoke, lib, entry):
    """The keywords and positional arguments each side hands ``entry`` of
    its ``lib`` module (stopped there), and those of its data ``synth``."""
    import importlib

    out = {}
    for side, pkg, suffix in (("ref", "repro", ""), ("port", "repro_torch", "_torch")):
        mod = importlib.import_module(f"{pkg}.experiments.{lib}")
        log = out[side] = {"synth": [], "run": []}
        synth = "synth_mnist_like" if lib == "bayeslr" else "synth"
        _record(monkeypatch, mod, synth, log["synth"], through=True)
        _record(monkeypatch, mod, entry, log["run"], stop=True)
        ex = _example(name, suffix)
        with pytest.raises(_Stop):
            if side == "ref":
                ex.main(smoke=smoke)
            else:
                ex.run(smoke=smoke, device="cpu", log=_quiet)
    return out


_RUN_KEYS = {
    "multichain": ("bayeslr", ("num_chains", "num_steps", "batch_size", "epsilon", "sigma",
                               "overdisperse", "stepping", "schedule")),
    "dpmixture": ("jointdpm", ("num_chains", "num_cycles", "batch_size", "epsilon", "sigma_prop",
                               "w_moves")),
    "stochastic_volatility": ("stochvol", ("num_chains", "num_steps", "batch_size", "epsilon",
                                           "num_particles")),
}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("name", sorted(_RUN_KEYS))
def test_ensemble_examples_pass_reference_settings(monkeypatch, name, smoke):
    """multichain, dpmixture and stochastic volatility hand
    ``run_posterior_ensemble`` the reference example's settings (chains,
    steps or cycles, m, epsilon, the proposal's scale, the stepping, the
    schedule's and the model config's every field) at the smoke and the
    full size, after data of the same sizes (and, for stochastic
    volatility, the same true phi and sigma)."""
    lib, keys = _RUN_KEYS[name]
    got = _stopped_run(monkeypatch, name, smoke, lib, "run_posterior_ensemble")
    (_, rs), = got["ref"]["synth"]
    (_, ps), = got["port"]["synth"]
    assert rs == _drop(ps, "device")
    (ra, rk), = got["ref"]["run"]
    (pa, pk), = got["port"]["run"]
    assert set(keys) <= set(rk) and set(keys) <= set(pk)
    for k in keys:
        assert _same_fields(rk[k], pk[k]), k
    if lib == "jointdpm":  # the model config is the third positional argument
        assert _same_fields(ra[2], pa[2])


def test_serve_lm_passes_reference_flags(monkeypatch):
    """serve_lm's flags: the port's parser, without ``--smoke`` and
    ``--device``, parses to the reference's namespace (``--reduced`` on by
    default, the batch, lengths and temperature)."""
    parsed = []
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        ns = real(self, args, namespace)
        parsed.append(vars(ns))
        return ns

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    ref = _example("serve_lm", "")
    _record(monkeypatch, ref, "init_params", [], stop=True)
    with pytest.raises(_Stop):
        ref.main()
    port = vars(_example("serve_lm").parser().parse_args([]))
    assert parsed[0] == _drop(port, "smoke", "device")
    assert parsed[0]["reduced"] is True


# ---------------------------------------------------------------------------
# each example's numbers against the reference's library calls
# ---------------------------------------------------------------------------


def test_quickstart_against_reference_chain():
    """N=5000, D=10, 60 transitions a kernel on the reference's data (the
    settings handed to the library are held exactly by
    ``test_quickstart_passes_reference_settings``). The subsampled chain
    accepts, and its acceptance is within 0.2 of the reference's
    ``run_chain`` at the same settings and its evaluated fraction within
    0.05 (both ~0.12 here); the safeguard evaluates under a fifth of N; the
    exact and subsampled chains share their seed, so their posterior means
    differ by at most 0.1 (the reference's example: 0.0000 at this size)."""
    from repro.core import RandomWalk as JRW
    from repro.core import SubsampledMHConfig as JCfg
    from repro.core import run_chain as j_run_chain
    from repro.experiments import bayeslr as jb
    from repro_torch.experiments import bayeslr

    steps = 60
    jd = jb.synth_mnist_like(jax.random.key(0), n_train=5000, n_test=1000, d=10)
    data = bayeslr.LRData(*(_t(a) for a in jd))
    out = _example("quickstart").run(smoke=True, device="cpu", data=data, steps=steps,
                                     log=_quiet)
    target = jb.make_target(jd.x_train, jd.y_train)
    _, _, infos = j_run_chain(jax.random.key(2), jnp.zeros(10), target, JRW(0.03), steps,
                              config=JCfg(batch_size=200, epsilon=0.05, sampler="stream"))
    ref_acc = float(np.mean(np.asarray(infos.accepted)))
    ref_frac = float(np.mean(np.asarray(infos.n_evaluated))) / 5000
    sub = out["subsampled"]
    assert 0 < sub["acceptance"] and abs(sub["acceptance"] - ref_acc) <= 0.2, (
        sub["acceptance"], ref_acc)
    assert abs(sub["frac_evaluated"] - ref_frac) <= 0.05, (sub["frac_evaluated"], ref_frac)
    assert out["exact"]["frac_evaluated"] == 1.0
    assert out["report"]["mean_fraction_evaluated"] < 0.2
    assert out["posterior_mean_gap"] <= 0.1
    assert all(np.isfinite(v) for v in (out["speedup"], *out["exact"]["posterior_mean"]))


def test_multichain_against_reference_ensemble():
    """8 masked adaptive chains x 120 steps at N=2000, D=4 on the
    reference's data, against the reference's ``run_posterior_ensemble``
    with the same settings: overall acceptance within 0.15, evaluated
    fraction within 0.15 (0.36-0.40 at the smoke size), the posterior-mean
    test error within 0.05; adapted epsilon in [0.05, 0.2] and batch sizes
    in [1, N], as the reference's controller keeps them."""
    from repro.core import ScheduleConfig as JSched
    from repro.experiments import bayeslr as jb
    from repro_torch.experiments import bayeslr

    steps = 120
    jd = jb.synth_mnist_like(jax.random.key(0), n_train=2000, n_test=500, d=4)
    data = bayeslr.LRData(*(_t(a) for a in jd))
    out = _example("multichain").run(smoke=True, device="cpu", data=data, steps=steps,
                                     log=_quiet)
    samples, diag = jb.run_posterior_ensemble(
        jax.random.key(1), jd, num_chains=8, num_steps=steps, batch_size=500, epsilon=0.05,
        sigma=0.04, overdisperse=0.2, stepping="masked", schedule=JSched())
    w = np.asarray(samples)[:, steps // 2:].reshape(-1, 4).mean(0)
    ref_err = jb.test_error(w, np.asarray(jd.x_test), np.asarray(jd.y_test))
    ref_acc = float(np.mean(diag["accept_rate"]))
    ref_frac = diag["mean_n_evaluated_overall"] / 2000
    assert abs(out["accept_rate_overall"] - ref_acc) <= 0.15, (out["accept_rate_overall"], ref_acc)
    assert abs(out["frac_evaluated"] - ref_frac) <= 0.15, (out["frac_evaluated"], ref_frac)
    assert abs(out["test_error"] - ref_err) <= 0.05, (out["test_error"], ref_err)
    assert np.all((out["final_epsilon"] >= 0.05 - 1e-6) & (out["final_epsilon"] <= 0.2 + 1e-6))
    assert np.all((out["final_batch_eff"] >= 1) & (out["final_batch_eff"] <= 2000))
    assert np.isfinite(out["rhat_max"]) and out["ess_w0"] > 0


def test_dpmixture_against_reference_replicas():
    """2 replicas x 4 cycles of Fig. 7's program at N=800 on the
    reference's data, against the reference's ``run_posterior_ensemble``
    at the same settings: every replica's test accuracy above the initial
    state's, and the mean within 0.15 of the reference's; the w moves'
    acceptance within 0.25 and their evaluated fraction within 0.2."""
    from repro.experiments import jointdpm as jj
    from repro_torch.experiments import jointdpm

    cycles = 4
    jd = jj.synth(jax.random.key(0), n=800, n_test=200)
    data = jointdpm.JDPMData(*(_t(a) for a in jd[:4]))
    out = _example("dpmixture").run(smoke=True, device="cpu", data=data, cycles=cycles,
                                    log=_quiet)
    cfg = jj.JDPMConfig()
    state, _, _, diag = jj.run_posterior_ensemble(
        jax.random.key(2), jd, cfg, num_chains=2, num_cycles=cycles, batch_size=100,
        epsilon=0.3, sigma_prop=0.3, w_moves=5)
    ref_acc = [jj.accuracy(np.asarray(jj.predict_proba(jax.tree.map(lambda l: l[k], state.theta),
                                                       jd.x_test, cfg)), np.asarray(jd.y_test))
               for k in range(2)]
    assert np.all(out["accuracy"] > out["accuracy_before"]), out
    assert abs(float(np.mean(out["accuracy"])) - float(np.mean(ref_acc))) <= 0.15, ref_acc
    assert abs(float(np.mean(out["w_accept_rate"]))
               - float(np.mean(diag["w_accept_rate"]))) <= 0.25
    assert abs(out["w_frac_evaluated"] - float(diag["w_frac_evaluated"])) <= 0.2
    assert np.all(out["k_active_final"] >= 1)


def test_stochastic_volatility_against_reference_chains():
    """2 chains x 40 cycles at S=60, T=5, P=10 on the reference's data,
    against the reference's ``run_posterior_ensemble`` at the same
    settings: the posterior means of phi within 0.2 and of sigma within
    0.05 (the chains have not mixed at this size: R-hat 1.0-3.7 in both),
    the moves' evaluated fractions within 0.15."""
    from repro.experiments import stochvol as js
    from repro_torch.experiments import stochvol

    cycles = 40
    jd = js.synth(jax.random.key(0), num_series=60, length=5, phi=0.95, sigma=0.1)
    data = stochvol.SVData(*(_t(a) for a in jd))
    out = _example("stochastic_volatility").run(smoke=True, device="cpu", data=data,
                                                cycles=cycles, log=_quiet)
    _, samples, _, diag = js.run_posterior_ensemble(
        jax.random.key(1), jd, num_chains=2, num_steps=cycles, batch_size=100, epsilon=0.01,
        num_particles=10)
    burn = cycles // 3
    ref_phi = float(np.asarray(samples["phi"])[:, burn:].mean())
    ref_sigma = float(np.sqrt(np.asarray(samples["sigma2"])[:, burn:]).mean())
    assert abs(out["phi_mean"] - ref_phi) <= 0.2, (out["phi_mean"], ref_phi)
    assert abs(out["sigma_mean"] - ref_sigma) <= 0.05, (out["sigma_mean"], ref_sigma)
    for name in ("phi", "sigma2"):
        assert abs(out["frac_evaluated"][name] - diag["frac_evaluated"][name]) <= 0.15, name


def test_serve_lm_against_reference_decode():
    """The reduced chatglm3-6b from the reference's parameters (key 0,
    converted), ``--smoke``: the prefill's last logits against the
    reference's ``prefill`` on the same prompts, the RMS difference within
    3e-2 of the logits' RMS (bf16; ``chip_smoke.py``'s decoding bar),
    every generated token a vocabulary id, the rates finite; ``--reduced``
    is on by default, as in the reference."""
    from repro.configs import ARCHS as J_ARCHS
    from repro.configs import reduce_config as j_reduce
    from repro.models import init_params as j_init
    from repro.models import prefill as j_prefill
    from repro_torch import convert
    from repro_torch._device import make_generator
    from repro_torch.models import prefill

    ex = _example("serve_lm")
    args = ex.parser().parse_args(["--smoke", "--device", "cpu"])
    assert args.reduced
    jcfg = j_reduce(J_ARCHS["chatglm3-6b"])
    jp = j_init(jax.random.key(0), jcfg)
    params = convert.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    out = ex.run(args, params=params, log=_quiet)
    assert out["tokens"].shape == (2, 8)
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < jcfg.vocab
    assert out["logits_finite"] and np.isfinite(out["decode_tok_s"])
    prompts = torch.randint(0, jcfg.vocab, (2, 8), dtype=torch.int32,
                            generator=make_generator(1, "cpu"))
    from repro_torch.configs import ARCHS, reduce_config

    _, got = prefill(params, prompts, reduce_config(ARCHS["chatglm3-6b"]), 24)
    _, want = j_prefill(jp, jnp.asarray(prompts.numpy()), jcfg, 24)
    want = np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(want ** 2)))
    diff = float(np.sqrt(np.mean((got.float().numpy() - want) ** 2)))
    assert diff <= 3e-2 * rms, (diff, rms)
