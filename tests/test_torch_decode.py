"""The port's decoding path against the JAX package: flash attention, the
KV caches, ``prefill`` / ``decode_step``, the xLSTM family and the front
end's ``--workload lm``, at ``reduce_config`` sizes on the CPU.

Parameters are drawn by the JAX package and carried across with
``convert.lm_params``; the reference's own decode caches with
``convert.lm_cache``. Tokens and attention inputs are made with numpy from
a seed. float32 results are held at ``test_forward_matches_jax``'s
tolerances unless a case names its own.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_config as j_reduce
from repro.launch import serve as j_serve
from repro.models import decode_step as j_decode
from repro.models import forward_hidden as j_hidden
from repro.models import forward_loglik as j_loglik
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init
from repro.models import param_specs as j_specs
from repro.models import prefill as j_prefill
from repro.models.layers import _attend_flash as j_flash
from repro.models.ssm import mlstm_block as j_mlstm
from repro.models.ssm import slstm_block as j_slstm
from repro.models.transformer import abstract_cache as j_abstract_cache
from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import (abstract_cache, decode_step, forward_hidden, forward_loglik,
                                init_cache, param_specs, prefill)
from repro_torch.models.layers import _attend_dense, _attend_flash
from repro_torch.models.ssm import mlstm_block, slstm_block
from repro_torch.models.transformer import _flatten

torch.set_num_threads(1)
DENSE = ["chatglm3-6b", "qwen1.5-32b", "gemma3-4b", "internlm2-20b"]
NEW_FAMILIES = ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b", "whisper-base",
                "chameleon-34b"]


def _jax_params(jcfg, dtype=jnp.float32, seed=0):
    return jax.tree.map(lambda a: a.astype(dtype), j_init(jax.random.key(seed), jcfg))


def _port(tree):
    return convert.lm_params(jax.tree.map(np.asarray, tree), device="cpu")


def _tokens(seed, b, s, v):
    return np.random.default_rng(seed).integers(0, v, (b, s)).astype(np.int32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def _bf16_ulp(a):
    """One bf16 ulp at each element's magnitude (8 bits of mantissa)."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _hold_cache(got, want):
    """The port's cache against the reference's: int leaves exact; bf16 and
    fp8 leaves within one ulp of their type at each element, plus 1e-5 of
    the leaf's largest magnitude (the float32 values before the rounding
    differ by the forward's tolerance, so a key near zero may round apart
    by more than its own ulp); float32 states at the forward's tolerance
    (1e-4 of their largest magnitude)."""
    got_l, want_l = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert tuple(g.shape) == w.shape
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g.numpy(), w)
            continue
        gf, wf = g.float().numpy(), w.astype(np.float32)
        slack = 1e-5 * np.abs(wf).max()
        if w.dtype.name == "bfloat16":
            assert np.all(np.abs(gf - wf) <= _bf16_ulp(wf) + slack), float(np.abs(gf - wf).max())
        elif w.dtype.name == "float8_e4m3fn":
            mag = np.maximum(np.abs(wf), 2.0 ** -6)
            assert np.all(np.abs(gf - wf) <= 2.0 ** (np.floor(np.log2(mag)) - 3) + slack)
        else:
            np.testing.assert_allclose(gf, wf, rtol=0, atol=1e-4 * max(np.abs(wf).max(), 1.0))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [1 << 30, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference_and_dense(window, causal):
    """At the reference test's shape and chunks (S = 64, chunk_q 16,
    chunk_kv 24: 64 rows pad to whole kv chunks), float32: the port's flash
    equals the reference's within 1e-5 and the port's dense within the
    reference test's 2e-3."""
    rng = np.random.default_rng(0)
    b, s, n_kv, group, hd = 2, 64, 2, 3, 16
    qg = rng.standard_normal((b, s, n_kv, group, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    want = np.asarray(j_flash(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), jnp.arange(s),
                              jnp.arange(s), window, causal, hd ** -0.5, chunk_q=16, chunk_kv=24))
    t = [torch.tensor(a) for a in (qg, k, v)]
    pos = torch.arange(s)
    got = _attend_flash(*t, pos, pos, window, causal, hd ** -0.5, chunk_q=16, chunk_kv=24)
    dense = _attend_dense(*t, pos, pos, window, causal, hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-3, atol=2e-3)


def test_forward_above_flash_threshold_matches_reference():
    """2 049 and 2 100 query rows take the flash path in both packages (the
    reference's default chunks, 256 x 512, the last q chunk padded): hidden
    states within 5e-4 of their largest magnitude, float32. The bar is this
    case's own: the two frameworks' float32 differences grow with the
    sequence (2e-4 at 2 048 rows on the dense path in both, 6e-5 at 64),
    while the two flash paths alone agree within 1e-6."""
    name = "chatglm3-6b"
    jcfg, cfg = j_reduce(J_ARCHS[name]), reduce_config(ARCHS[name])
    jp = _jax_params(jcfg)
    tp = _port(jp)
    for s in (2049, 2100):
        tok = _tokens(s, 1, s, cfg.vocab)
        want = np.asarray(j_hidden(jp, jnp.asarray(tok), jcfg))
        got = forward_hidden(tp, torch.tensor(tok), cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# caches, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE + ["xlstm-350m"] + NEW_FAMILIES)
def test_prefill_and_decode_match_reference(name, monkeypatch):
    """float32 parameters: prefill's cache and last logits, then three
    decode steps, each from the reference's own cache (``lm_cache``), against
    the reference's: logits within 1e-5 (relative to their largest
    magnitude for the prefill, 1e-4 for a decode step, which attends its own
    key as rounded into the bf16 cache, where the two frameworks may round
    one ulp apart; 1e-4 throughout for the recurrent families' float32
    state, xLSTM's and the hybrid's Mamba), caches as ``_hold_cache`` says
    (the k/v caches are bf16, as the reference's ``init_cache`` makes them;
    the hybrid's conv state comes back in the activations' dtype, float32
    here, as the reference's does). The audio family's prefill encodes
    frames (0.1 N(0, 1), numpy seed 12) and keeps ``enc_out`` in the cache;
    each decode step reads it from the reference's cache.
    A prefill of 10 tokens into 24 slots attends its keys as rounded into
    the bf16 cache too, so the new families' prefill logits are held at the
    decode steps' 1e-4 (whisper: 5 of 6 144 cached keys round one bf16 ulp
    apart in the two packages here and move the logits by 1.2e-5 of their
    largest; with no key apart they agree to 5e-7). jamba-v0.1-52b runs
    with float32 k/v caches in both packages (``init_cache``'s dtype
    patched in both): with bf16 ones one of its 1 536 keys rounds apart,
    which moves the logits by 1.0e-4 and the later Mamba layers' float32
    states by up to 2.7e-4 of their largest, past the states' 1e-4."""
    jcfg, cfg = j_reduce(J_ARCHS[name]), reduce_config(ARCHS[name])
    jp = _jax_params(jcfg)
    tp = _port(jp)
    tok = _tokens(4, 2, 14, cfg.vocab)
    tol = 1e-5 if name in DENSE else 1e-4
    if cfg.family == "hybrid":
        import repro.models.transformer as jt
        import repro_torch.models.transformer as tt

        monkeypatch.setattr(jt, "init_cache", functools.partial(jt.init_cache, dtype=jnp.float32))
        monkeypatch.setattr(tt, "init_cache", functools.partial(tt.init_cache, dtype=torch.float32))
    jextra = textra = None
    if cfg.family == "audio":
        frames = 0.1 * np.random.default_rng(12).standard_normal(
            (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        jextra, textra = {"frames": jnp.asarray(frames)}, {"frames": torch.tensor(frames)}
    jcache, jl = j_prefill(jp, jnp.asarray(tok[:, :10]), jcfg, 24, jextra)
    tcache, tl = prefill(tp, torch.tensor(tok[:, :10]), cfg, 24, textra)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=tol * np.abs(jl).max())
    _hold_cache(tcache, jcache)
    for t in range(10, 13):
        step = jnp.asarray(tok[:, t:t + 1])
        tcache, tl = decode_step(tp, convert.lm_cache(jax.tree.map(np.asarray, jcache),
                                                      device="cpu"), torch.tensor(tok[:, t:t + 1]),
                                 cfg)
        jcache, jl = j_decode(jp, jcache, step, jcfg)
        jl = np.asarray(jl)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())
        _hold_cache(tcache, jcache)


def test_decode_runs_on_its_own_cache_against_the_forward():
    """Without the reference's caches: the port's prefill and six
    teacher-forced decode steps, each on the port's own cache, against the
    reference's chain on its own caches (logits within 1e-3 of their largest
    magnitude: the bf16 keys may round one ulp apart) and against the
    no-cache forward of the grown sequence (bf16 caches against a float32
    forward: the RMS of the difference within 8e-2 of the logits' RMS at
    every step; 4e-2 at most measured)."""
    name = "chatglm3-6b"
    jcfg, cfg = j_reduce(J_ARCHS[name]), reduce_config(ARCHS[name])
    jp = _jax_params(jcfg)
    tp = _port(jp)
    tok = _tokens(5, 2, 16, cfg.vocab)
    h = forward_hidden(tp, torch.tensor(tok), cfg)
    full = torch.einsum("bsd,vd->bsv", h, tp["embed"]["table"])
    jcache, jl = j_prefill(jp, jnp.asarray(tok[:, :10]), jcfg, 32)
    cache, lg = prefill(tp, torch.tensor(tok[:, :10]), cfg, 32)
    rms = lambda t: float(t.pow(2).mean().sqrt())
    for t in range(10, 17):
        jl = np.asarray(jl)
        np.testing.assert_allclose(lg.numpy(), jl, rtol=0, atol=1e-3 * np.abs(jl).max())
        assert rms(lg - full[:, t - 1]) <= 8e-2 * rms(full[:, t - 1]), t
        if t < 16:
            cache, lg = decode_step(tp, cache, torch.tensor(tok[:, t:t + 1]), cfg)
            jcache, jl = j_decode(jp, jcache, jnp.asarray(tok[:, t:t + 1]), jcfg)
    assert int(cache["len"]) == 16 and cache["pos"].tolist()[:16] == list(range(16))
    assert cache["pos"].tolist()[16:] == [-1] * 16


def test_ring_cache_matches_reference():
    """A window-8 ring (chatglm3-6b reduced with ``window=8``): a 12-token
    prefill fills the ring by ``roll`` (slot p % 8), then six decode steps
    overwrite the oldest slots; each against the reference from its cache."""
    jcfg = dataclasses.replace(j_reduce(J_ARCHS["chatglm3-6b"]), window=8)
    cfg = dataclasses.replace(reduce_config(ARCHS["chatglm3-6b"]), window=8)
    jp = _jax_params(jcfg)
    tp = _port(jp)
    tok = _tokens(6, 1, 18, cfg.vocab)
    jcache, jl = j_prefill(jp, jnp.asarray(tok[:, :12]), jcfg, 64)
    tcache, tl = prefill(tp, torch.tensor(tok[:, :12]), cfg, 64)
    assert tcache["k"].shape[2] == 8
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jl)).max())
    _hold_cache(tcache, jcache)
    for t in range(12, 18):
        tcache, tl = decode_step(tp, convert.lm_cache(jax.tree.map(np.asarray, jcache),
                                                      device="cpu"), torch.tensor(tok[:, t:t + 1]),
                                 cfg)
        jcache, jl = j_decode(jp, jcache, jnp.asarray(tok[:, t:t + 1]), jcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jl)).max())
        _hold_cache(tcache, jcache)


def test_fp8_cache_matches_reference():
    """An fp8 (float8_e4m3fn) cache, dequantized on read: a prompt decoded
    token by token from an empty fp8 cache in both packages; logits within
    1e-4 of their largest magnitude (the step's own key is attended as
    rounded into the cache), the fp8 k/v within one fp8 ulp."""
    jcfg = dataclasses.replace(j_reduce(J_ARCHS["chatglm3-6b"]), kv_cache_dtype="fp8")
    cfg = dataclasses.replace(reduce_config(ARCHS["chatglm3-6b"]), kv_cache_dtype="fp8")
    jp = _jax_params(jcfg)
    tp = _port(jp)
    tok = _tokens(7, 2, 6, cfg.vocab)
    jcache = j_init_cache(jcfg, 2, 16, jnp.float8_e4m3fn)
    tcache = init_cache(cfg, 2, 16, torch.float8_e4m3fn, device="cpu")
    _hold_cache(tcache, jcache)
    assert tcache["k"].dtype == torch.float8_e4m3fn
    for t in range(6):
        if t:  # the first step runs on the port's own empty cache, the rest on the reference's
            tcache = convert.lm_cache(jax.tree.map(np.asarray, jcache), device="cpu")
        tcache, tl = decode_step(tp, tcache, torch.tensor(tok[:, t:t + 1]), cfg)
        jcache, jl = j_decode(jp, jcache, jnp.asarray(tok[:, t:t + 1]), jcfg)
        _hold_cache(tcache, jcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(jl)).max())


@pytest.mark.parametrize("name", ["chatglm3-6b", "xlstm-350m"] + NEW_FAMILIES)
def test_cache_templates_match_reference(name):
    """``abstract_cache`` (meta-device tensors) has the reference's leaves,
    shapes and dtypes, at full size and without allocating; ``init_cache``
    its initial values."""
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    got = _leaves(abstract_cache(cfg, 8, 136))
    want = _leaves(j_abstract_cache(jcfg, 8, 136))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert all(g.device.type == "meta" for g in got)
    assert [str(g.dtype).split(".")[-1] for g in got] == [str(w.dtype) for w in want]
    rc, jrc = reduce_config(cfg), j_reduce(jcfg)
    _hold_cache(init_cache(rc, 2, 20, device="cpu"), j_init_cache(jrc, 2, 20))


# ---------------------------------------------------------------------------
# the xLSTM family
# ---------------------------------------------------------------------------


def test_xlstm_param_specs_match_reference_at_full_size():
    cfg, jcfg = ARCHS["xlstm-350m"], J_ARCHS["xlstm-350m"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduce_config(cfg)) == dataclasses.asdict(j_reduce(jcfg))

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            out.update(flat(v, path) if isinstance(v, dict) else {path: v})
        return out

    want, got = flat(j_specs(jcfg)), _flatten(param_specs(cfg))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert tuple(spec.shape) == tuple(want[path].shape), path
        assert tuple(spec.logical) == tuple(want[path].logical), path
        assert spec.init_scale == want[path].init_scale, path
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
@pytest.mark.parametrize("with_state", [False, True])
def test_xlstm_blocks_match_reference(block, with_state):
    """One block on (2, 7, 64) float32 inputs, from no state and from the
    state a first call left: outputs and every state leaf within 1e-5 of
    their largest magnitude."""
    jcfg = j_reduce(J_ARCHS["xlstm-350m"])
    jp = jax.tree.map(lambda a: a[1], _jax_params(jcfg)["layers"][block])
    tp = _port(jp)
    jfn, tfn = (j_mlstm, mlstm_block) if block == "mlstm" else (j_slstm, slstm_block)
    rng = np.random.default_rng(8)
    x0, x1 = (rng.standard_normal((2, 7, 64)).astype(np.float32) for _ in range(2))
    jst = tst = None
    if with_state:
        _, jst = jfn(jnp.asarray(x0), jp)
        tst = type(jst)(*(torch.tensor(np.asarray(a)) for a in jst))
    jy, jnew = jfn(jnp.asarray(x1), jp, jst)
    ty, tnew = tfn(torch.tensor(x1), tp, tst)
    for g, w in zip([ty, *tnew], [jy, *jnew]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_xlstm_forward_loglik_matches_reference(prec):
    """As ``test_forward_matches_jax``: fp32 within 1e-5 relative; bf16
    within 2e-3 relative."""
    jcfg, cfg = j_reduce(J_ARCHS["xlstm-350m"]), reduce_config(ARCHS["xlstm-350m"])
    jp = _jax_params(jcfg, jnp.float32 if prec == "fp32" else jnp.bfloat16)
    tp = _port(jp)
    tok = _tokens(9, 3, 20, cfg.vocab)
    want = np.asarray(j_loglik(jp, {"tokens": jnp.asarray(tok)}, jcfg, ce_chunk=8))
    got = forward_loglik(tp, {"tokens": torch.tensor(tok)}, cfg, ce_chunk=8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5 if prec == "fp32" else 2e-3)


# ---------------------------------------------------------------------------
# the front end: --workload lm
# ---------------------------------------------------------------------------


def test_serve_lm_prints_both_lines_on_cpu(capsys):
    assert serve.main(["--workload", "lm", "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen-len", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("prefill 2x8: ") and lines[-2].endswith("tok/s)")
    assert lines[-1].startswith("decode 4 steps: ") and lines[-1].endswith("tok/s)")


def test_serve_lm_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--workload", "lm", "--reduced"])


def test_serve_lm_restores_a_train_checkpoint(tmp_path, capsys):
    """``--ckpt-dir`` decodes from the launcher's last checkpoint: the
    parameters ``serve_lm`` used are the checkpoint's, every bit, and its
    prefill logits are the no-cache forward's at the prompt's last position."""
    d = str(tmp_path / "chain")
    trained = train.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4",
                          "--seq", "12", "--sigma", "5e-3", "--ckpt-dir", d])
    args = serve.build_parser().parse_args(
        ["--workload", "lm", "--arch", "chatglm3-6b", "--reduced", "--device", "cpu",
         "--batch", "2", "--prompt-len", "6", "--gen-len", "3", "--ckpt-dir", d])
    out = {}
    assert serve.serve_lm(args, out) == 0
    assert "restored posterior sample from" in capsys.readouterr().out
    _, saved = ckpt.restore(d, target=out["params"])
    for a, b, c in zip(_flatten(out["params"]).values(), _flatten(saved).values(),
                       _flatten(trained["params"]).values()):
        assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, c)
    h = forward_hidden(out["params"], out["prompts"], out["cfg"])
    want = torch.einsum("bd,vd->bv", h[:, -1], out["params"]["embed"]["table"]).float()
    assert torch.equal(out["prefill_logits"], want)


@pytest.mark.parametrize("argv", [
    ["--batch", "4"],
    ["--arch", "chatglm3-6b"],
    ["--workload", "bayeslr", "--gen-len", "3"],
    ["--workload", "lm", "--fleet"],
    ["--workload", "lm", "--subposterior", "2"],
    ["--workload", "lm", "--stream"],
    ["--workload", "lm", "--autoscale"],
    ["--workload", "lm", "--alerts"],
    ["--workload", "lm", "--soak"],
])
def test_lm_flag_guards_as_reference(argv):
    """Each misuse the reference's front end refuses with a usage error, the
    port's refuses too, before anything runs."""
    for main in (j_serve.main, serve.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2, (main, argv)


def test_lm_model_parallel_raises(tmp_path):
    """``--model-parallel 2`` raises where one slot cannot split in two; with
    ``--devices 4`` (a 2 x 2 mesh of CPU slots) it decodes, from random
    parameters and from a ``launch.train`` checkpoint restored onto the
    mesh's pieces, every prefill logit and generated token the unsharded
    run's bit for bit."""
    from repro_torch.distributed import ShardedTensor
    from repro_torch.launch import train

    base = ["--workload", "lm", "--reduced", "--device", "cpu", "--arch", "chatglm3-6b",
            "--batch", "2", "--prompt-len", "6", "--gen-len", "4"]
    with pytest.raises(ValueError, match="model=2"):
        serve.main(base + ["--model-parallel", "2"])
    train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "8",
                "--ckpt-dir", str(tmp_path)])
    for extra in ([], ["--ckpt-dir", str(tmp_path)]):
        outs = []
        for mp in ([], ["--model-parallel", "2", "--devices", "4"]):
            out = {}
            args = serve.build_parser().parse_args(base + extra + mp)
            assert serve.serve_lm(args, out) == 0
            outs.append(out)
        one, two = outs
        assert isinstance(two["params"]["embed"]["table"], ShardedTensor)
        assert torch.equal(one["prefill_logits"], two["prefill_logits"])
        assert one["tokens"].shape == (2, 4) and torch.equal(one["tokens"], two["tokens"])
