"""The port's LM stack (the dense family's forward and the LM's MH steps:
plain, cached and MALA) against the JAX package, at the reduced sizes of
``reduce_config``. Decoding and the xLSTM family: ``test_torch_decode.py``.

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

from repro.bayes import LogLikCache as JLogLikCache
from repro.bayes import TrainConfig as JTrainConfig
from repro.bayes import make_cached_train_step as j_cached_step
from repro.bayes import make_exact_step as j_exact_step
from repro.bayes import make_train_step as j_train_step
from repro.bayes.train import _prior_delta as j_prior_delta
from repro.bayes.train import _tree_normal_like as j_normal_like
from repro.bayes.train import _tree_rw_propose as j_propose
from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_config as j_reduce
from repro.core import sequential_test as j_sequential_test
from repro.core.samplers import StreamSliceState as JStreamState
from repro.core.samplers import stream_draw as j_stream_draw
from repro.core.samplers import stream_reset as j_stream_reset
from repro.data import DataConfig as JDataConfig
from repro.data import MarkovStream as JMarkovStream
from repro.models import forward_hidden as j_hidden
from repro.models import forward_loglik as j_loglik
from repro.models import init_params as j_init
from repro.models import param_specs as j_specs
from repro_torch import convert
from repro_torch.bayes import (LogLikCache, TrainConfig, cached_decide, exact_decide,
                               make_cached_train_step, make_train_step, mala_grads, mala_move,
                               propose, subsampled_decide)
from repro_torch.bayes.train import _flat_paths, _prior_delta, _sq_total
from repro_torch.core import sequential_test
from repro_torch.core.samplers import StreamSliceState, stream_draw, stream_reset
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.data import DataConfig, MarkovStream, TokenStream
from repro_torch.models import forward_hidden, forward_loglik, init_params, param_specs
from repro_torch.models.transformer import ModelConfig, _flatten
from repro_torch.runtime import InjectedFailure, LoopConfig, run_loop

torch.set_num_threads(1)
DENSE = ["chatglm3-6b", "qwen1.5-32b", "gemma3-4b", "internlm2-20b"]
NEW_FAMILIES = ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b", "whisper-base",
                "chameleon-34b"]


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
    """``reduce_config`` is the reference's for all ten architectures; no
    family is deferred any more: an unknown one raises ValueError, and 2 049+
    query rows (the flash path) run."""
    assert list(ARCHS) == list(J_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(reduce_config(ARCHS[name])) == \
            dataclasses.asdict(j_reduce(J_ARCHS[name]))
    for name in ARCHS:
        param_specs(reduce_config(ARCHS[name]))
    cfg = dataclasses.replace(ARCHS["chatglm3-6b"], family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        param_specs(cfg)
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    h = forward_hidden(init_params(0, cfg, device="cpu"), torch.zeros((1, 2049), dtype=torch.int32),
                       cfg)
    assert h.shape == (1, 2049, cfg.d_model) and bool(torch.isfinite(h.float()).all())
    assert param_specs(ARCHS["xlstm-350m"])["layers"]["mlstm"]["wq"].shape == (12, 1024, 4, 256)


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


def _router_gaps(monkeypatch):
    """Wrap the port's ``moe_mlp`` to keep, for every call, each token's gap
    between its k-th and (k+1)-th router logits in bf16 ulps of the k-th."""
    import repro_torch.models.transformer as tr

    real, gaps = tr.moe_mlp, []

    def recorded(x, p, *, top_k, **kw):
        lg = torch.einsum("bsd,de->bse", x, p["router"]).float()
        top = torch.sort(lg, dim=-1, descending=True).values
        ulp = 2.0 ** (torch.floor(torch.log2(top[..., top_k - 1].abs().clamp_min(1e-30))) - 7)
        gaps.append(((top[..., top_k - 1] - top[..., top_k]) / ulp).min().item())
        return real(x, p, top_k=top_k, **kw)

    monkeypatch.setattr(tr, "moe_mlp", recorded)
    return gaps


@pytest.mark.parametrize("name", DENSE + NEW_FAMILIES)
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_forward_matches_jax(name, prec, monkeypatch):
    """fp32: hidden states within 1e-4 of their largest magnitude, per-
    sequence log-likelihoods within 1e-5 relative. bf16 (the default dtype):
    the two frameworks round the bf16 products at other places, and one
    flipped ulp propagates through the layers; the hidden states agree to 5e-2
    in RMS relative to their RMS and the log-likelihoods to 2e-3 relative.
    The audio family is given frames (0.1 N(0, 1), numpy seed 11) in both.
    In bf16 a router near-tie could send a token to another expert in the
    two packages, so for the moe and hybrid families the case asserts its own
    precondition: on every token of every MoE layer the k-th and (k+1)-th
    router logits of the port's forward lie more than 2 bf16 ulps apart.
    These cases take 2 x 12 tokens, and their numpy seed is the first from 1
    up for which it holds: a gap of 2 ulps or less comes on 0.6-1.4% of
    token-layers at these sizes, so over 3 x 24 tokens through jamba's 4 MoE
    layers it held on none of 30 seeds.
    The five configurations of the moe, hybrid, audio and vlm families are
    held in bf16 to the reference compiled with XLA's
    ``xla_allow_excess_precision`` off, which rounds to bf16 where its code
    says, as the port does: by default XLA fuses elementwise chains inside
    ``lax.scan`` in float32, and for whisper-base and jamba-v0.1-52b that run
    differs from the reference's own op-by-op run (``jax.disable_jit``) by
    6.4e-2 and 8.2e-2 of the hidden states' RMS at these sizes, above the
    bar. Against the strict run the port's hidden states are equal bit for
    bit in most cases here (at most 9.4e-4 of the RMS apart)."""
    jcfg, cfg = j_reduce(J_ARCHS[name]), reduce_config(ARCHS[name])
    dtype = jnp.float32 if prec == "fp32" else jnp.bfloat16
    jp = _jax_params(name, dtype)
    tp = _port(jp)
    extra = {}
    if cfg.family == "audio":
        frames = 0.1 * np.random.default_rng(11).standard_normal(
            (3, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        extra = {"frames": jnp.asarray(frames).astype(dtype)}
    textra = {k: convert.lm_params(np.asarray(v), device="cpu") for k, v in extra.items()}
    routed = prec == "bf16" and cfg.family in ("moe", "hybrid")
    gaps = _router_gaps(monkeypatch) if routed else []
    for seed in range(1, 31):
        tok = _tokens(seed, *((2, 12) if routed else (3, 24)), cfg.vocab)
        gaps.clear()
        th = forward_hidden(tp, torch.tensor(tok), cfg, textra or None).float().numpy()
        if all(g > 2 for g in gaps):
            break
    assert all(g > 2 for g in gaps), gaps
    options = {"xla_allow_excess_precision": False} if prec == "bf16" and \
        name in NEW_FAMILIES else None

    def run(fn, *args):
        if options is None:
            return np.asarray(fn(*args))
        return np.asarray(jax.jit(fn).lower(*args).compile(compiler_options=options)(*args))

    jh = run(lambda p, t, e: j_hidden(p, t, jcfg, e or None).astype(jnp.float32), jp,
             jnp.asarray(tok), extra)
    jl = run(lambda p, b: j_loglik(p, b, jcfg, ce_chunk=8), jp,
             {"tokens": jnp.asarray(tok), **extra})
    tl = forward_loglik(tp, {"tokens": torch.tensor(tok), **textra}, cfg, ce_chunk=8).numpy()
    assert th.shape == jh.shape and tl.shape == (tok.shape[0],)
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
    """What still raises on the LM's train path: an unknown proposal, MALA
    without the batch its gradient needs, a cache of another pool's size.
    ``proposal="mala"`` and the cached step build, and MALA over parameters
    sharded on a mesh proposes the unsharded theta' and log u bit for bit
    (tests/test_torch_mala_mesh.py holds it further)."""
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    with pytest.raises(ValueError, match="unknown proposal"):
        make_train_step(cfg, TrainConfig(proposal="hmc"))
    params = init_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        propose(torch.Generator().manual_seed(0), params, TrainConfig(proposal="mala"))
    make_train_step(cfg, TrainConfig(proposal="mala"))
    step = make_cached_train_step(cfg, TrainConfig(cached=True))
    batch = TokenStream(DataConfig(cfg.vocab, 8, 4, 1), device="cpu").batch(0)
    with pytest.raises(ValueError, match="pool"):
        step(torch.Generator().manual_seed(0), params, batch, LogLikCache.empty(5, device="cpu"))
    from repro_torch.distributed import force_devices, shard_params
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models import param_specs

    with force_devices(4):
        mesh = make_mesh_for_devices(model_parallel=2, device="cpu")
        sharded = shard_params(params, mesh, specs=param_specs(cfg))
        got = propose(torch.Generator().manual_seed(0), sharded, TrainConfig(proposal="mala"),
                      batch, cfg)
    want = propose(torch.Generator().manual_seed(0), params, TrainConfig(proposal="mala"),
                   batch, cfg)
    assert torch.equal(got[1], want[1])
    for (_, a), (_, b) in zip(_flat_paths(got[0]), _flat_paths(want[0])):
        assert torch.equal(a.gather().view(torch.int16), b.view(torch.int16))


# ---------------------------------------------------------------------------
# the sequential test's aux, the lazy log-likelihood cache
# ---------------------------------------------------------------------------


def test_sequential_test_aux_matches_reference():
    """A stateful evaluator (``aux``: rounds seen and a running sum of the
    drawn offsets) under the stream sampler: the same rounds, decision,
    n_evaluated and final aux as the reference's ``sequential_test(aux=)``;
    without ``aux`` the result's aux is ``()``."""
    n, m = 200, 16
    vals = np.random.default_rng(0).normal(0.02, 1.0, n).astype(np.float32)

    def j_eval(idx, aux):
        return jnp.asarray(vals)[idx], (aux[0] + 1, aux[1] + idx.sum())

    def t_eval(idx, aux):
        return torch.tensor(vals)[idx.long()], (aux[0] + 1, aux[1] + idx.long().sum())

    for mu0 in (-0.3, 0.0, 0.01, 0.3):
        want = j_sequential_test(
            key=jax.random.key(0), mu0=jnp.float32(mu0), draw_fn=j_stream_draw, eval_fn=j_eval,
            sampler_state=j_stream_reset(JStreamState(jnp.zeros((), jnp.int32), n)),
            num_sections=n, batch_size=m, epsilon=0.05,
            aux=(jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)))
        got = sequential_test(None, torch.tensor(mu0), stream_draw, t_eval,
                              stream_reset(StreamSliceState(torch.zeros((), dtype=torch.int32), n)),
                              n, m, 0.05, aux=(0, torch.zeros((), dtype=torch.int64)))
        assert (bool(got.decision), int(got.rounds), int(got.n_evaluated)) == \
            (bool(want.decision), int(want.rounds), int(want.n_evaluated)), mu0
        assert (got.aux[0], int(got.aux[1])) == (int(want.aux[0]), int(want.aux[1])), mu0
    plain = sequential_test(None, torch.tensor(-0.3), stream_draw,
                            lambda idx: torch.tensor(vals)[idx.long()],
                            stream_reset(StreamSliceState(torch.zeros((), dtype=torch.int32), n)),
                            n, m, 0.05)
    assert plain.aux == ()


def _port_cache(jcache):
    return LogLikCache(torch.tensor(np.asarray(jcache.ll)), torch.tensor(np.asarray(jcache.valid)))


def test_cached_decide_matches_reference_given_its_proposal():
    """Six steps of the reference's cached step from an empty cache; at each
    the port's ``cached_decide`` is handed the reference's parameters, cache,
    theta' and log u: the same decision, rounds and n_evaluated, the
    returned cache's ``valid`` exact and its ``ll`` within 1e-5 relative
    (float32), and its host mirror equal to ``valid``."""
    jcfg, cfg, jp, tp, jbatch, tbatch = _step_case()
    kw = dict(round_batch=4, epsilon=0.05, sigma=1e-2, prior_var=1e6)
    jstep = jax.jit(j_cached_step(jcfg, JTrainConfig(**kw)))
    jcache = JLogLikCache.empty(16)
    rows, partial = [], 0
    for s in range(6):
        key = jax.random.key(300 + s)
        thp, log_u = _reference_proposal(key, jp, kw["sigma"])
        new, tcache, tinfo = cached_decide(cfg, TrainConfig(**kw), _port(jp), _port(thp),
                                           torch.tensor(np.asarray(log_u)), tbatch,
                                           _port_cache(jcache))
        jp, jcache, info = jstep(key, jp, jbatch, jcache)
        rows.append(bool(info.accepted))
        assert [bool(tinfo.accepted), int(tinfo.rounds), int(tinfo.n_evaluated)] == \
            [bool(info.accepted), int(info.rounds), int(info.n_evaluated)], s
        np.testing.assert_array_equal(tcache.valid.numpy(), np.asarray(jcache.valid))
        np.testing.assert_array_equal(tcache.valid_host, np.asarray(jcache.valid))
        np.testing.assert_allclose(tcache.ll.numpy(), np.asarray(jcache.ll), rtol=1e-5)
        partial += int(0 < np.asarray(jcache.valid).sum() < 16)
    assert 0 < sum(rows) < len(rows) and partial > 0


def test_cached_step_equals_uncached_step_bit_for_bit():
    """Six steps from one generator seed: the cached step's decisions,
    rounds, n_evaluated, mu_hat and final parameters are the plain step's,
    bit for bit on the CPU, while it runs fewer theta forwards."""
    import repro_torch.bayes.train as bt

    cfg = reduce_config(ARCHS["chatglm3-6b"])
    params = init_params(0, cfg, device="cpu")
    batch = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=24, global_batch=8, seed=0),
                        device="cpu").batch(0)
    tc = TrainConfig(round_batch=2, epsilon=0.2, sigma=1e-3)
    calls = {"n": 0}
    real = bt.forward_loglik

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    bt.forward_loglik = counting
    try:
        runs = {}
        for name, cached in (("plain", False), ("cached", True)):
            calls["n"] = 0
            gen = torch.Generator().manual_seed(5)
            th, infos = params, []
            cache = LogLikCache.empty(8, device="cpu")
            step = make_cached_train_step(cfg, tc) if cached else make_train_step(cfg, tc)
            for _ in range(6):
                if cached:
                    th, cache, info = step(gen, th, batch, cache)
                else:
                    th, info = step(gen, th, batch)
                infos.append(info)
            runs[name] = (th, infos, calls["n"])
    finally:
        bt.forward_loglik = real
    (th_p, inf_p, n_p), (th_c, inf_c, n_c) = runs["plain"], runs["cached"]
    for a, b in zip(inf_p, inf_c):
        for f in ("accepted", "rounds", "n_evaluated", "mu_hat", "mu0", "pvalue"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for a, b in zip(_flatten(th_p).values(), _flatten(th_c).values()):
        assert torch.equal(a, b)
    rounds = sum(int(i.rounds) for i in inf_p)
    assert n_p == 2 * rounds and rounds < n_c < 2 * rounds
    assert 0 < sum(bool(i.accepted) for i in inf_p) < 6


def test_cache_goes_stale_on_accept_and_warm_on_reject():
    """As the reference's test: after an accept only the evaluated sections
    are valid, holding l(theta'); after a reject the cache keeps what it had
    and gains the evaluated sections, holding l(theta)."""
    _, cfg, _, tp, _, tbatch = _step_case()
    tc = TrainConfig(round_batch=4, epsilon=0.9, sigma=0.0)
    full = forward_loglik(tp, tbatch, cfg, ce_chunk=tc.ce_chunk)
    # a full sweep with theta' = theta and l = 0 everywhere: no test until the
    # pool is exhausted; log u > 0 rejects, and every section is valid
    _, cache, info = cached_decide(cfg, tc, tp, tp, torch.tensor(1.0), tbatch,
                                   LogLikCache.empty(16, device="cpu"))
    assert not bool(info.accepted) and int(info.n_evaluated) == 16
    assert bool(cache.valid.all()) and cache.valid_host.all()
    np.testing.assert_allclose(cache.ll.numpy(), full.numpy(), rtol=1e-6)
    # warm on reject: a proposal far off, log u huge: the first round decides
    thp = propose(torch.Generator().manual_seed(1), tp, TrainConfig(sigma=0.05))[0]
    new, warm, info = cached_decide(cfg, tc, tp, thp, torch.tensor(1e4), tbatch, cache)
    assert new is tp and not bool(info.accepted) and int(info.n_evaluated) < 16
    assert bool(warm.valid.all()) and torch.equal(warm.ll, cache.ll)
    # stale on accept: log u far below zero accepts after the first round
    new, stale, info = cached_decide(cfg, tc, tp, thp, torch.tensor(-1e4), tbatch, cache)
    assert new is thp and bool(info.accepted)
    n = int(info.n_evaluated)
    assert int(stale.valid.sum()) == n < 16 and stale.valid_host.sum() == n
    l_new = forward_loglik(thp, {k: v[:n] for k, v in tbatch.items()}, cfg,
                           ce_chunk=tc.ce_chunk)
    assert torch.equal(stale.ll[:n], l_new)
    assert bool(cache.valid.all())  # the caller's cache is not changed


# ---------------------------------------------------------------------------
# MALA
# ---------------------------------------------------------------------------


def _j_logpost_grad(jcfg, tc, jp, jbatch):
    """The reference's MALA gradient, as its step takes it."""
    pool = jbatch["tokens"].shape[0]
    rb = min(tc.round_batch, pool)
    n = tc.dataset_size or pool

    def logpost_est(t):
        rows = {k: v[:rb] for k, v in jbatch.items()}
        ll = j_loglik(t, rows, jcfg, ce_chunk=tc.ce_chunk).sum() * (n / rb)
        pr = sum(jnp.sum(jnp.square(l.astype(jnp.float32))) for l in jax.tree.leaves(t))
        return ll - 0.5 * pr / tc.prior_var

    return jax.grad(logpost_est)(jp)


def test_mala_gradient_matches_jax_grad():
    """float32, at prior_var 1 and 0.5: the port's gradient (autograd of the
    first round_batch rows' log-likelihood times N / rb, plus the prior's
    cotangent) against ``jax.grad``'s. Every leaf but the tied embedding
    table within 1e-4 of the gradient's largest component, and every leaf
    within 2e-4 of its own largest. The table holds that largest component
    (~2e3): its gradient adds the embedding's, which comes back through the
    first RMS norm of 0.02-scale rows (a gain of ~1 / 0.02) and sums terms
    that cancel. Measured: 1.1e-4 of its largest component between the two
    packages, each 2-3e-4 from the same gradient taken in float64, and
    ~1e-4 of their own largest on the attention leaves: float32 rounding in
    both, not another gradient."""
    jcfg, cfg, jp, tp, jbatch, tbatch = _step_case()
    for prior_var in (1.0, 0.5):
        jtc = JTrainConfig(round_batch=4, proposal="mala", prior_var=prior_var)
        tc = TrainConfig(round_batch=4, proposal="mala", prior_var=prior_var)
        want = _jax_flat(jax.tree.map(np.asarray, _j_logpost_grad(jcfg, jtc, jp, jbatch)))
        top = max(float(np.abs(w).max()) for w in want.values())
        got = mala_grads(cfg, tc, tp, tbatch)
        assert list(got) == sorted(want)
        for path, g in got.items():
            w = want[path]
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 2e-4 * np.abs(w).max(), (path, err)
            assert path == "embed/table" or err <= 1e-4 * top, (path, err)


def test_mala_gradient_grows_with_depth_as_reference():
    """The randomly initialised model's gradient grows by orders of
    magnitude with depth, in the reference as in the port (float32, a
    d_model 256 variant of chatglm3-6b): 8 layers' largest component is
    over 100 times 2 layers' in both, and at each depth the two packages'
    agree within a factor of 1.5 (the float32 differences grow with the
    gradient: 17% apart at 8 layers here). At chatglm3-6b's 28 layers
    this is why a MALA step of 1e-8 moves theta far off (``chip_smoke.py``
    phase H-mala records the largest component)."""
    top = {}
    for layers in (2, 8):
        kw = dict(n_layers=layers, d_model=256, n_heads=8, n_kv=2, d_ff=512, vocab=4096,
                  head_dim=None)
        jcfg = dataclasses.replace(j_reduce(J_ARCHS["chatglm3-6b"]), **kw)
        cfg = dataclasses.replace(reduce_config(ARCHS["chatglm3-6b"]), **kw)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), j_init(jax.random.key(0), jcfg))
        tok = _tokens(6, 8, 32, cfg.vocab)
        jtc = JTrainConfig(round_batch=4, proposal="mala")
        want = _j_logpost_grad(jcfg, jtc, jp, {"tokens": jnp.asarray(tok)})
        got = mala_grads(cfg, TrainConfig(round_batch=4, proposal="mala"), _port(jp),
                         {"tokens": torch.tensor(tok)})
        w = max(float(np.abs(np.asarray(v)).max()) for v in jax.tree.leaves(want))
        g = max(float(v.abs().max()) for v in got.values())
        assert w / 1.5 <= g <= 1.5 * w, (layers, g, w)
        top[layers] = (w, g)
    assert top[8][0] > 100 * top[2][0] and top[8][1] > 100 * top[2][1], top


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mala_move_from_reference_noise(dtype):
    """Given the reference's gradient and its xi (``_tree_normal_like``, so a
    bf16 xi is bf16-rounded), theta' = theta + step/2 g + sqrt(step) xi
    equals the reference's within float32 rounding (one ulp of the result's
    type at each element)."""
    jcfg, cfg, _, _, jbatch, _ = _step_case()
    jp = _jax_params("chatglm3-6b", dtype)
    tp = _port(jp)
    jtc = JTrainConfig(round_batch=4, proposal="mala", mala_step=1e-4)
    g = _j_logpost_grad(jcfg, jtc, jp, jbatch)
    xi = _j_normal_like(jax.random.key(4), jp)
    want = jax.tree.map(
        lambda t, gg, n: (t.astype(jnp.float32) + 0.5 * jtc.mala_step * gg.astype(jnp.float32)
                          + jtc.mala_step ** 0.5 * n.astype(jnp.float32)).astype(t.dtype),
        jp, g, xi)
    grads = {p: l for p, l in _flat_paths(_port(g))}
    got = mala_move(tp, grads, TrainConfig(proposal="mala", mala_step=1e-4),
                    dict(_flat_paths(_port(xi))))
    assert grads == {}  # consumed leaf by leaf
    eps = 2.0 ** (-23 if dtype == jnp.float32 else -7)
    for (path, w), t in zip(_jax_flat(jax.tree.map(np.asarray, want)).items(),
                            _flatten(got).values()):
        w = w.astype(np.float32)
        assert t.dtype == tp["embed"]["table"].dtype
        assert np.all(np.abs(t.float().numpy() - w) <= eps * np.abs(w) + 1e-30), path


def _j_normal_like(key, tree):
    return j_normal_like(key, tree)


def test_mala_decisions_match_jax_given_its_proposal():
    """The reference's MALA step over 8 keys; the port's test handed the
    reference's theta' (its gradient and xi under its key split) and log u
    reaches the same decision after the same rounds with the same
    n_evaluated. The port's own MALA step runs and keeps its parameters
    finite."""
    jcfg, cfg, jp, tp, jbatch, tbatch = _step_case()
    kw = dict(round_batch=4, epsilon=0.05, proposal="mala", mala_step=3e-4, prior_var=1e6)
    jstep = jax.jit(j_train_step(jcfg, JTrainConfig(**kw)))
    g = _j_logpost_grad(jcfg, JTrainConfig(**kw), jp, jbatch)
    got, want = [], []
    for s in range(8):
        key = jax.random.key(400 + s)
        _, info = jstep(key, jp, jbatch)
        k_u, k_prop, _ = jax.random.split(key, 3)
        log_u = jnp.log(jax.random.uniform(k_u, (), jnp.float32, 1e-20, 1.0))
        xi = j_normal_like(k_prop, jp)
        step = kw["mala_step"]
        thp = jax.tree.map(lambda t, gg, n: t + 0.5 * step * gg + step ** 0.5 * n, jp, g, xi)
        _, tinfo = subsampled_decide(cfg, TrainConfig(**kw), tp, _port(thp),
                                     torch.tensor(np.asarray(log_u)), tbatch)
        want.append([bool(info.accepted), int(info.rounds), int(info.n_evaluated)])
        got.append([bool(tinfo.accepted), int(tinfo.rounds), int(tinfo.n_evaluated)])
    assert got == want
    assert 0 < sum(w[0] for w in want) < len(want)
    new, info = make_train_step(cfg, TrainConfig(**kw))(torch.Generator().manual_seed(2), tp,
                                                        tbatch)
    assert all(bool(torch.isfinite(l).all()) for l in _flatten(new).values())


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
