"""The port's LM stack (dense family) against the JAX package, at the
reduced sizes of ``reduce_config``.

Parameters are drawn by the JAX package and carried across with
``convert.lm_params``; tokens are made with numpy from a seed. Forward
passes are compared in float32 (and in bf16 at a looser tolerance). The
subsampled-MH train step is handed the reference's own theta' and log u, so
the sequential test (stream sampler, no randomness) must reach the same
decision after the same rounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bayes import TrainConfig as JTrainConfig
from repro.bayes import make_exact_step as j_exact_step
from repro.bayes import make_train_step as j_train_step
from repro.bayes.train import _prior_delta as j_prior_delta
from repro.bayes.train import _tree_rw_propose as j_propose
from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_config as j_reduce
from repro.data import DataConfig as JDataConfig
from repro.data import MarkovStream as JMarkovStream
from repro.models import forward_hidden as j_hidden
from repro.models import forward_loglik as j_loglik
from repro.models import init_params as j_init
from repro.models import param_specs as j_specs
from repro_torch import convert
from repro_torch.bayes import TrainConfig, exact_decide, make_train_step, propose, subsampled_decide
from repro_torch.bayes.train import _flat_paths, _prior_delta, _sq_total
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.data import DataConfig, MarkovStream, TokenStream
from repro_torch.models import forward_hidden, forward_loglik, init_params, param_specs
from repro_torch.models.transformer import ModelConfig, _flatten
from repro_torch.runtime import InjectedFailure, LoopConfig, run_loop

torch.set_num_threads(1)
DENSE = ["chatglm3-6b", "qwen1.5-32b", "gemma3-4b", "internlm2-20b"]


def _jax_params(name, dtype=jnp.float32, seed=0):
    p = j_init(jax.random.key(seed), j_reduce(J_ARCHS[name]))
    return jax.tree.map(lambda a: a.astype(dtype), p)


def _port(tree):
    return convert.lm_params(jax.tree.map(np.asarray, tree), device="cpu")


def _tokens(seed, b, s, v):
    return np.random.default_rng(seed).integers(0, v, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configurations and parameter trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
def test_param_specs_match_reference_at_full_size(name):
    """Every leaf's path, shape and logical axes equal the reference's at the
    published size, without allocating; the config is the same value."""
    cfg = ARCHS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(J_ARCHS[name])
    want = _jax_flat(j_specs(J_ARCHS[name]))
    got = _flatten(param_specs(cfg))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert tuple(spec.shape) == tuple(want[path].shape), path
        assert tuple(spec.logical) == tuple(want[path].logical), path
        assert spec.init_scale == want[path].init_scale, path
    assert cfg.param_count() == J_ARCHS[name].param_count()
    if name == "chatglm3-6b":
        assert cfg.param_count() == 5_977_116_672


def _jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_jax_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_reduce_config_and_deferred_families():
    for name in DENSE:
        assert dataclasses.asdict(reduce_config(ARCHS[name])) == \
            dataclasses.asdict(j_reduce(J_ARCHS[name]))
    moe = dataclasses.replace(ARCHS["chatglm3-6b"], family="moe")
    with pytest.raises(NotImplementedError):
        param_specs(moe)
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    with pytest.raises(NotImplementedError, match="FLASH_THRESHOLD"):
        forward_hidden(init_params(0, cfg, device="cpu"), torch.zeros((1, 2049), dtype=torch.int32),
                       cfg)


def test_init_params_shapes_dtypes_and_scale():
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    params = init_params(0, cfg, device="cpu")
    flat = _flatten(params)
    specs = _flatten(param_specs(cfg))
    for path, leaf in flat.items():
        assert tuple(leaf.shape) == specs[path].shape and leaf.dtype == torch.bfloat16, path
    assert float(flat["final_norm"].float().abs().max()) == 0.0  # zero init
    std = float(flat["embed/table"].float().std())
    assert 0.018 < std < 0.022  # the "embed" scale 0.02
    again = init_params(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(flat.values(), _flatten(again).values()))


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_forward_matches_jax(name, prec):
    """fp32: hidden states within 1e-4 of their largest magnitude, per-
    sequence log-likelihoods within 1e-5 relative. bf16 (the default dtype):
    the two frameworks round the bf16 products at other places, and one
    flipped ulp propagates through the layers; the hidden states agree to 5e-2
    in RMS relative to their RMS and the log-likelihoods to 2e-3 relative."""
    jcfg, cfg = j_reduce(J_ARCHS[name]), reduce_config(ARCHS[name])
    jp = _jax_params(name, jnp.float32 if prec == "fp32" else jnp.bfloat16)
    tp = _port(jp)
    tok = _tokens(1, 3, 24, cfg.vocab)
    jh = np.asarray(j_hidden(jp, jnp.asarray(tok), jcfg).astype(jnp.float32))
    th = forward_hidden(tp, torch.tensor(tok), cfg).float().numpy()
    jl = np.asarray(j_loglik(jp, {"tokens": jnp.asarray(tok)}, jcfg, ce_chunk=8))
    tl = forward_loglik(tp, {"tokens": torch.tensor(tok)}, cfg, ce_chunk=8).numpy()
    assert th.shape == jh.shape and tl.shape == (3,)
    if prec == "fp32":
        np.testing.assert_allclose(th, jh, rtol=0, atol=1e-4 * np.abs(jh).max())
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    else:
        rms = lambda a: float(np.sqrt(np.mean(a.astype(np.float64) ** 2)))
        assert rms(th - jh) <= 5e-2 * rms(jh)
        np.testing.assert_allclose(tl, jl, rtol=2e-3)


def test_forward_loglik_mask_and_chunks():
    """The chunk size does not change the result (the reference pads to a
    multiple of the chunk; the port runs a shorter last chunk), and masked
    positions drop out, as in JAX."""
    name = "chatglm3-6b"
    jcfg, cfg = j_reduce(J_ARCHS[name]), reduce_config(ARCHS[name])
    jp = _jax_params(name)
    tp = _port(jp)
    tok = _tokens(2, 2, 19, cfg.vocab)
    mask = np.ones_like(tok)
    mask[1, 10:] = 0
    want = np.asarray(j_loglik(jp, {"tokens": jnp.asarray(tok), "mask": jnp.asarray(mask)},
                               jcfg, ce_chunk=5))
    for chunk in (5, 7, 512):
        got = forward_loglik(tp, {"tokens": torch.tensor(tok), "mask": torch.tensor(mask)}, cfg,
                             ce_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the subsampled-MH train step
# ---------------------------------------------------------------------------


def _step_case(name="chatglm3-6b", pool=16, seq=16):
    jcfg, cfg = j_reduce(J_ARCHS[name]), reduce_config(ARCHS[name])
    jp = _jax_params(name)
    tok = _tokens(3, pool, seq, cfg.vocab)
    jbatch = {"tokens": jnp.asarray(tok), "mask": jnp.ones(tok.shape, jnp.int32)}
    tbatch = {"tokens": torch.tensor(tok), "mask": torch.ones(tok.shape, dtype=torch.int32)}
    return jcfg, cfg, jp, _port(jp), jbatch, tbatch


def _reference_proposal(key, jp, sigma, n_split=3, paths=None):
    """theta' and log u exactly as the reference's step draws them."""
    keys = jax.random.split(key, n_split)
    log_u = jnp.log(jax.random.uniform(keys[0], (), jnp.float32, 1e-20, 1.0))
    return j_propose(keys[1], jp, sigma, paths), log_u


# (prior_var, sigma, mu0 atol): the wide prior makes the global term ~1e-5,
# so mu0 agrees to float32 rounding; at the reference's default prior_var
# 1.0 (sigma 2e-3, so that some proposals are accepted) the two prior deltas
# differ by the backends' summation orders inside each leaf (~0.03, see
# test_prior_delta_matches_reference), which over N = 16 sections moves mu0
# by up to ~2e-3; decisions, rounds and n_evaluated still match exactly.
STEP_CASES = [(1e6, 1e-2, 1e-7), (1.0, 2e-3, 4e-3)]


@pytest.mark.parametrize("prior_var,sigma,mu0_atol", STEP_CASES)
def test_train_step_matches_jax_given_its_proposal(prior_var, sigma, mu0_atol):
    """Given the reference's theta' (its own ``_tree_rw_propose`` with its
    key split) and log u, the port's step reaches the same decision after the
    same rounds with the same n_evaluated, on every key."""
    jcfg, cfg, jp, tp, jbatch, tbatch = _step_case()
    kw = dict(round_batch=4, epsilon=0.05, sigma=sigma, prior_var=prior_var)
    jstep = jax.jit(j_train_step(jcfg, JTrainConfig(**kw)))
    got, want = [], []
    for s in range(8):
        key = jax.random.key(100 + s)
        _, info = jstep(key, jp, jbatch)
        thp, log_u = _reference_proposal(key, jp, kw["sigma"])
        new, tinfo = subsampled_decide(cfg, TrainConfig(**kw), tp, _port(thp),
                                       torch.tensor(np.asarray(log_u)), tbatch)
        want.append([bool(info.accepted), int(info.rounds), int(info.n_evaluated)])
        got.append([bool(tinfo.accepted), int(tinfo.rounds), int(tinfo.n_evaluated)])
        np.testing.assert_allclose(float(tinfo.mu_hat), float(info.mu_hat), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(tinfo.mu0), float(info.mu0), rtol=1e-5, atol=mu0_atol)
        assert (new is tp) != bool(tinfo.accepted)
    assert got == want
    acc = [g[0] for g in got]
    assert 0 < sum(acc) < len(acc) and len({g[1] for g in got}) > 1


def _ulp(x):
    return float(np.spacing(np.float32(abs(x))))


@pytest.mark.parametrize("paths", [None, ("final_norm",)])
def test_prior_delta_matches_reference(paths):
    """The port's prior delta is the reference's: (-0.5 / prior_var) times
    the difference of two float32 totals of squares over every leaf, in the
    reference's leaf order, the leaves theta' shares with theta included.

    Within 4 ulps of the larger total, times 0.5 / prior_var, plus what the
    two backends' orders of summation inside each leaf allow: XLA's CPU
    reduction sums each leaf in windows of up to 32 per axis, each window
    sequentially, which rounds a leaf's sum many ulps from the exact one
    (~0.03 in all from the exact delta at this size); the port sums a leaf
    by chunked dot products. That allowance is the sum over
    the leaves of both trees of each side's distance from the float64 leaf
    sum. Where only ``final_norm`` moves, every other leaf's sum is the same
    in both totals on each side, so 4 ulps alone must hold."""
    _, _, jp, tp, _, _ = _step_case()
    thp = j_propose(jax.random.key(5), jp, 0.01, paths)
    prior_var = 1.0
    port = float(_prior_delta(tp, _port(thp), prior_var))
    ref = float(j_prior_delta(jp, thp, prior_var))
    totals, order = [], 0.0
    for tree, ttree in ((jp, tp), (thp, _port(thp))):
        total = 0.0
        for (path, leaf), tleaf in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                       [l for _, l in _flat_paths(ttree)]):
            exact = float(np.sum(np.square(np.asarray(leaf, np.float64))))
            if paths is None:
                order += abs(float(jnp.sum(jnp.square(leaf.astype(jnp.float32)))) - exact)
                order += abs(float(_sq_total({"x": tleaf})) - exact)
            total += exact
        totals.append(total)
    tol = (4 * _ulp(max(totals)) + order) * 0.5 / prior_var
    assert abs(port - ref) <= tol, (port, ref, tol)


@pytest.mark.parametrize("prior_var,sigma,mu0_atol", STEP_CASES)
def test_exact_step_matches_jax(prior_var, sigma, mu0_atol):
    jcfg, cfg, jp, tp, jbatch, tbatch = _step_case()
    kw = dict(round_batch=4, sigma=sigma, prior_var=prior_var)
    jstep = jax.jit(j_exact_step(jcfg, JTrainConfig(**kw)))
    got, want = [], []
    for s in range(6):
        key = jax.random.key(200 + s)
        _, info = jstep(key, jp, jbatch)
        thp, log_u = _reference_proposal(key, jp, kw["sigma"], n_split=2)
        _, tinfo = exact_decide(cfg, TrainConfig(**kw), tp, _port(thp),
                                torch.tensor(np.asarray(log_u)), tbatch)
        want.append(bool(info.accepted))
        got.append(bool(tinfo.accepted))
        assert int(tinfo.n_evaluated) == 16 and int(tinfo.rounds) == 4
        np.testing.assert_allclose(float(tinfo.mu_hat), float(info.mu_hat), rtol=1e-4, atol=1e-5)
    assert got == want and 0 < sum(got) < len(got)


def test_propose_paths_freezes_other_leaves():
    """As the reference's test: with propose_paths=("final_norm",) only that
    leaf moves; the others are the very same tensors (nothing is copied)."""
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    params = init_params(0, cfg, device="cpu")
    tc = TrainConfig(round_batch=2, epsilon=0.9, sigma=0.5, propose_paths=("final_norm",))
    gen = torch.Generator().manual_seed(3)
    theta_p, _ = propose(gen, params, tc)
    moved = {p for p, (a, b) in zip(_flatten(params), zip(_flatten(params).values(),
                                                          _flatten(theta_p).values()))
             if a is not b}
    assert moved == {"final_norm"}
    assert not torch.equal(params["final_norm"], theta_p["final_norm"])
    batch = TokenStream(DataConfig(cfg.vocab, 8, 4, 1), device="cpu").batch(0)
    new, info = make_train_step(cfg, tc)(gen, params, batch)
    assert new["embed"]["table"] is params["embed"]["table"]


def test_deferred_train_paths_raise():
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    for tc in (TrainConfig(proposal="mala"), TrainConfig(cached=True)):
        with pytest.raises(NotImplementedError):
            make_train_step(cfg, tc)


# ---------------------------------------------------------------------------
# the loop, the data, the launcher
# ---------------------------------------------------------------------------


def test_run_loop_resume_equals_clean_run(tmp_path):
    """As ``tests/test_substrates.py``: a run stopped by an injected failure
    and resumed from its checkpoint ends where an uninterrupted run ends."""
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    params = init_params(0, cfg, device="cpu")
    step = make_train_step(cfg, TrainConfig(round_batch=2, max_rounds=2, epsilon=0.3,
                                            sigma=5e-3))
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1),
                         device="cpu")
    d_clean, d_crash = str(tmp_path / "clean"), str(tmp_path / "crash")
    clean = run_loop(step, params, stream.batch,
                     LoopConfig(num_steps=6, ckpt_dir=d_clean, ckpt_every=2, seed=9))
    with pytest.raises(InjectedFailure):
        run_loop(step, params, stream.batch,
                 LoopConfig(num_steps=6, ckpt_dir=d_crash, ckpt_every=2, seed=9, fail_at_step=4))
    resumed = run_loop(step, params, stream.batch,
                       LoopConfig(num_steps=6, ckpt_dir=d_crash, ckpt_every=2, seed=9))
    assert len(resumed["infos"]) == 2  # steps 4 and 5 after the restore
    for a, b in zip(_flatten(clean["params"]).values(), _flatten(resumed["params"]).values()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(clean["infos"][4:], resumed["infos"]):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert any(bool(i["accepted"]) for i in clean["infos"])


def test_markov_stream_deterministic_and_peaked_as_reference():
    """Deterministic per (seed, step) and different across steps; by
    distribution, the next token is the most likely one out of its
    predecessor's row about as often as in the reference's stream (~0.47;
    the matrices are different draws, so the two fractions agree to the
    spread between draws)."""
    s = MarkovStream(DataConfig(128, 64, 64, 0), device="cpu")
    a, b, c = s.batch(3)["tokens"], s.batch(3)["tokens"], s.batch(4)["tokens"]
    assert torch.equal(a, b) and not torch.equal(a, c) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 128
    port, ref = [], []
    for seed in (0, 1, 2):
        ts = MarkovStream(DataConfig(128, 64, 64, seed), device="cpu")
        tok = ts.batch(0)["tokens"].long()
        prev = tok[:, :-1].reshape(-1)
        port.append(float((ts.row_logits(prev).argmax(-1) == tok[:, 1:].reshape(-1)).float().mean()))
        js = JMarkovStream(JDataConfig(vocab=128, seq_len=64, global_batch=64, seed=seed))
        jt = np.asarray(js.batch(0)["tokens"])
        ref.append(float(np.mean(np.asarray(js.trans_logits)[jt[:, :-1]].argmax(-1) == jt[:, 1:])))
    assert abs(np.mean(port) - np.mean(ref)) < 0.06, (port, ref)
    assert 0.3 < np.mean(port) < 0.7 and 0.3 < np.mean(ref) < 0.7


def test_launcher_runs_on_cpu_and_needs_the_card_by_default(tmp_path, monkeypatch):
    from repro_torch.launch import train

    out = train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "8",
                      "--seq", "12", "--ckpt-dir", str(tmp_path / "a")])
    assert len(out["infos"]) == 2 and out["step"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path / "b")])


def test_convert_keeps_bf16_bits():
    jp = _jax_params("chatglm3-6b", jnp.bfloat16)
    tp = _port(jp)
    for (path, a), b in zip(_jax_flat(jp).items(), _flatten(tp).values()):
        assert b.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    assert isinstance(ARCHS["chatglm3-6b"], ModelConfig)
