"""The port's moe, hybrid, audio and vlm families against the JAX package:
the five configurations' specs at full size, ``moe_mlp``, ``mamba_block``,
``layer_norm`` and ``gelu_mlp``, the train step on a reduced moe and hybrid
model given the reference's proposal, a sliding-window ring under MoE, and
the two launchers on the CPU. Forward and decoding parity of the families
are parametrised cases of ``test_torch_lm.py::test_forward_matches_jax`` and
``test_torch_decode.py``.

Inputs are made with numpy from a seed and handed to both packages;
parameters of whole models are drawn by the JAX package and carried across
with ``convert.lm_params``. float32 throughout unless a case says otherwise.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bayes import TrainConfig as JTrainConfig
from repro.bayes import make_train_step as j_train_step
from repro.bayes.train import _tree_rw_propose as j_propose
from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import reduce_config as j_reduce
from repro.configs import shape_applicable as j_shape_applicable
from repro.launch import train as j_train
from repro.models import decode_step as j_decode
from repro.models import forward_loglik as j_loglik
from repro.models import init_params as j_init
from repro.models import param_specs as j_specs
from repro.models import prefill as j_prefill
from repro.models.layers import gelu_mlp as j_gelu_mlp
from repro.models.layers import layer_norm as j_layer_norm
from repro.models.layers import moe_mlp as j_moe_mlp
from repro.models.ssm import MambaState as JMambaState
from repro.models.ssm import mamba_block as j_mamba
from repro_torch import convert
from repro_torch.bayes import TrainConfig, subsampled_decide
from repro_torch.configs import ARCHS, SHAPES, reduce_config, shape_applicable
from repro_torch.launch import serve, train
from repro_torch.models import (abstract_params, decode_step, forward_loglik, param_specs,
                                prefill)
from repro_torch.models.layers import gelu_mlp, layer_norm, moe_mlp, record_moe_drops
from repro_torch.models.ssm import MambaState, mamba_block
from repro_torch.models.transformer import _flatten

torch.set_num_threads(1)
NEW = ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b", "whisper-base",
       "chameleon-34b"]


def _t(a):
    return torch.tensor(np.asarray(a))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _port(tree):
    return convert.lm_params(jax.tree.map(np.asarray, tree), device="cpu")


def _near(got, want, tol):
    """Within ``tol`` of the largest magnitude of ``want``."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NEW)
def test_specs_and_counts_match_reference_at_full_size(name):
    """The config is the reference's value; every leaf's path, shape, dtype,
    logical axes and init equal the reference's at the published size, with
    nothing allocated (``abstract_params`` on the meta device); so do
    ``param_count`` and ``active_param_count``."""
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want, got = _flat(j_specs(jcfg)), _flatten(param_specs(cfg))
    assert set(got) == set(want)
    for path, spec in got.items():
        w = want[path]
        assert tuple(spec.shape) == tuple(w.shape), path
        assert tuple(spec.logical) == tuple(w.logical), path
        assert spec.init_scale == w.init_scale, path
        assert str(spec.dtype).split(".")[-1] == str(jnp.dtype(w.dtype)), path
    meta = _flatten(abstract_params(cfg))
    assert all(t.device.type == "meta" and tuple(t.shape) == tuple(want[p].shape)
               for p, t in meta.items())
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_registry_shapes_and_reduced_configs_match_reference():
    """``ARCHS`` has the reference's ten architectures in its order;
    ``shape_applicable`` answers as the reference's for all ten x four
    shapes; ``reduce_config`` is the reference's for each."""
    assert list(ARCHS) == list(J_ARCHS)
    assert list(SHAPES) == list(J_SHAPES)
    for arch in ARCHS:
        assert dataclasses.asdict(reduce_config(ARCHS[arch])) == \
            dataclasses.asdict(j_reduce(J_ARCHS[arch]))
        for shape in SHAPES:
            assert shape_applicable(arch, shape) == j_shape_applicable(arch, shape)
    assert [a for a in ARCHS if not shape_applicable(a, "long_500k")[0]] == [
        "qwen1.5-32b", "gemma3-4b", "internlm2-20b", "chatglm3-6b", "phi3.5-moe-42b-a6.6b",
        "whisper-base", "chameleon-34b"]


# ---------------------------------------------------------------------------
# moe_mlp
# ---------------------------------------------------------------------------


def _moe_inputs(seed, b, s, d=16, f=32, e=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    p = {"router": rng.standard_normal((d, e)) * 0.5,
         "wi_gate": rng.standard_normal((e, d, f)) * 0.1,
         "wi_up": rng.standard_normal((e, d, f)) * 0.1,
         "wo": rng.standard_normal((e, f, d)) * 0.1}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def _drops(x, p, **kw):
    with record_moe_drops() as log:
        y = moe_mlp(_t(x), {k: _t(v) for k, v in p.items()}, **kw)
    return y, sum(n for n, _ in log), int(sum(int(d) for _, d in log))


def test_moe_without_drops_matches_the_per_expert_loop():
    """Capacity large enough that nothing drops (``capacity_factor = E``):
    the dispatch equals the explicit per-expert loop of the reference's
    ``tests/test_models.py::test_moe_matches_dense_reference`` (run in JAX),
    within 1e-5 of max |y|."""
    b, s, e, k = 2, 8, 4, 2
    x, p = _moe_inputs(0, b, s, e=e)
    got, n, dropped = _drops(x, p, top_k=k, capacity_factor=float(e))
    assert (n, dropped) == (b * s * k, 0)
    xj = jnp.asarray(x)
    gate_all = jax.nn.softmax(jnp.einsum("bsd,de->bse", xj, p["router"]), -1)
    gate, sel = jax.lax.top_k(gate_all, k)
    gate = gate / gate.sum(-1, keepdims=True)
    want = jnp.zeros_like(xj)
    for ei in range(e):
        g = jax.nn.silu(jnp.einsum("bsd,df->bsf", xj, p["wi_gate"][ei]))
        u = jnp.einsum("bsd,df->bsf", xj, p["wi_up"][ei])
        y = jnp.einsum("bsf,fd->bsd", g * u, p["wo"][ei])
        want = want + ((sel == ei) * gate).sum(-1)[..., None] * y
    _near(got, want, 1e-5)
    _near(got, j_moe_mlp(xj, p, top_k=k, capacity_factor=float(e)), 1e-5)


@pytest.mark.parametrize("case", ["drops", "groups", "chunks"])
def test_moe_matches_reference_dispatch(case):
    """Against the reference's ``moe_mlp`` on the same inputs, within 1e-5
    of max |y|: with drops (``capacity_factor=0.5``: 64 tokens, capacity 32
    against a mean load of 32 an expert), on the ``n_groups = B`` branch (B =
    16, S = 8: sixteen groups of 8 tokens) and on the chunked branch (one
    group of 16 384 tokens, d = 16: two chunks of 8 192). The dropped
    assignments are counted, and the drop case drops some."""
    shape, kw = {"drops": ((2, 32), dict(capacity_factor=0.5)),
                 "groups": ((16, 8), {}),
                 "chunks": ((1, 16384), {})}[case]
    x, p = _moe_inputs(1, *shape)
    got, n, dropped = _drops(x, p, top_k=2, **kw)
    want = j_moe_mlp(jnp.asarray(x), p, top_k=2, **kw)
    _near(got, want, 1e-5)
    assert n == 2 * shape[0] * shape[1]
    assert (dropped > 0) == (case == "drops"), dropped


def test_moe_ties_go_to_the_lower_expert():
    """Equal router logits (a zero router): ``lax.top_k`` picks the lowest
    indices; so does the port's stable sort, so both pick experts 0 and 1."""
    x, p = _moe_inputs(2, 2, 4)
    p["router"] = np.zeros_like(p["router"])
    _near(moe_mlp(_t(x), {k: _t(v) for k, v in p.items()}, top_k=2),
          j_moe_mlp(jnp.asarray(x), p, top_k=2), 1e-5)


# ---------------------------------------------------------------------------
# mamba_block, layer_norm, gelu_mlp
# ---------------------------------------------------------------------------


def _mamba_params(seed, d=32, di=64, ds=8, dtr=8, k=4):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"in_proj": n(d, 2 * di) * d ** -0.5, "conv_w": n(k, di) * 0.5,
            "conv_b": n(di) * 0.1, "x_proj": n(di, dtr + 2 * ds) * di ** -0.5,
            "dt_proj": n(dtr, di) * dtr ** -0.5, "dt_bias": n(di) * 0.1,
            "a_log": n(di, ds) * 0.3, "d_skip": 1.0 + 0.1 * n(di),
            "out_proj": n(di, d) * di ** -0.5}


def test_mamba_block_matches_reference_with_and_without_state():
    """A 10-step prompt from no state, 6 more steps from its state, and a
    one-token continuation: outputs and both states (conv in the
    activations' dtype, ssm float32) within 1e-5 of their largest
    magnitude."""
    p = _mamba_params(3)
    tp = {k: _t(v) for k, v in p.items()}
    x = np.random.default_rng(4).standard_normal((2, 17, 32)).astype(np.float32)
    jy, jst = j_mamba(jnp.asarray(x[:, :10]), p)
    ty, tst = mamba_block(_t(x[:, :10]), tp)
    for s in (slice(10, 16), slice(16, 17)):
        _near(ty, jy, 1e-5)
        _near(tst.conv, jst.conv, 1e-5)
        _near(tst.ssm, jst.ssm, 1e-5)
        assert tst.ssm.dtype == torch.float32 and tst.conv.dtype == torch.float32
        jy, jst = j_mamba(jnp.asarray(x[:, s]), p, jst)
        ty, tst = mamba_block(_t(x[:, s]), tp, tst)
    _near(ty, jy, 1e-5)
    _near(tst.ssm, jst.ssm, 1e-5)
    # a bf16 conv state (the cache's dtype) continues in the activations' dtype
    conv16, ssm = np.asarray(jnp.asarray(jst.conv).astype(jnp.bfloat16)), jst.ssm
    jy, _ = j_mamba(jnp.asarray(x[:, 16:]), p, JMambaState(jnp.asarray(conv16), ssm))
    ty, tst = mamba_block(_t(x[:, 16:]), tp, MambaState(convert.lm_cache(conv16, device="cpu"),
                                                        _t(ssm)))
    _near(ty, jy, 1e-5)
    assert tst.conv.dtype == torch.float32


def test_layer_norm_and_gelu_mlp_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3 + 1
    g, b = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    _near(layer_norm(_t(x), _t(g), _t(b)), j_layer_norm(jnp.asarray(x), g, b), 1e-5)
    p = {"wi": rng.standard_normal((16, 32)) * 0.25, "bi": rng.standard_normal(32) * 0.1,
         "wo": rng.standard_normal((32, 16)) * 0.2, "bo": rng.standard_normal(16) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    _near(gelu_mlp(_t(x), {k: _t(v) for k, v in p.items()}), j_gelu_mlp(jnp.asarray(x), p), 1e-5)


# ---------------------------------------------------------------------------
# a sliding-window ring under MoE, the train step
# ---------------------------------------------------------------------------


def test_mixtral_ring_cache_matches_reference():
    """mixtral's reduced window of 32 as a ring: a 40-token prefill into a
    cache of 64 positions keeps 32 slots (filled by ``roll``), then four
    decode steps overwrite the oldest, each from the reference's cache;
    logits within 1e-4 of their largest magnitude."""
    name = "mixtral-8x22b"
    jcfg, cfg = j_reduce(J_ARCHS[name]), reduce_config(ARCHS[name])
    jp = j_init(jax.random.key(0), jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = _port(jp)
    tok = np.random.default_rng(6).integers(0, cfg.vocab, (2, 44)).astype(np.int32)
    jcache, jl = j_prefill(jp, jnp.asarray(tok[:, :40]), jcfg, 64)
    tcache, tl = prefill(tp, torch.tensor(tok[:, :40]), cfg, 64)
    assert tcache["k"].shape[2] == 32
    _near(tl, jl, 1e-5)
    assert torch.equal(tcache["pos"], _t(jcache["pos"]))
    for t in range(40, 44):
        tcache, tl = decode_step(tp, convert.lm_cache(jax.tree.map(np.asarray, jcache),
                                                      device="cpu"),
                                 torch.tensor(tok[:, t:t + 1]), cfg)
        jcache, jl = j_decode(jp, jcache, jnp.asarray(tok[:, t:t + 1]), jcfg)
        _near(tl, jl, 1e-4)
        assert torch.equal(tcache["pos"], _t(jcache["pos"]))


@pytest.mark.parametrize("name", ["mixtral-8x22b", "jamba-v0.1-52b"])
def test_train_step_matches_jax_given_its_proposal(name):
    """A reduced moe and a reduced hybrid model: given the reference's
    theta' (its own ``_tree_rw_propose`` with its key split) and log u, the
    port's subsampled step reaches the same decision after the same rounds
    with the same n_evaluated, on each of 4 keys (both decisions among
    them); mu_hat within 1e-4 relative."""
    jcfg, cfg = j_reduce(J_ARCHS[name]), reduce_config(ARCHS[name])
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), j_init(jax.random.key(0), jcfg))
    tp = _port(jp)
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (16, 16)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tok), "mask": jnp.ones(tok.shape, jnp.int32)}
    tbatch = {"tokens": torch.tensor(tok), "mask": torch.ones(tok.shape, dtype=torch.int32)}
    kw = dict(round_batch=4, epsilon=0.05, sigma=3e-3, prior_var=1e6)
    jstep = jax.jit(j_train_step(jcfg, JTrainConfig(**kw)))
    got, want = [], []
    for s in range(4):
        key = jax.random.key(100 + s)
        _, info = jstep(key, jp, jbatch)
        keys = jax.random.split(key, 3)
        log_u = jnp.log(jax.random.uniform(keys[0], (), jnp.float32, 1e-20, 1.0))
        thp = j_propose(keys[1], jp, kw["sigma"], None)
        _, tinfo = subsampled_decide(cfg, TrainConfig(**kw), tp, _port(thp),
                                     torch.tensor(np.asarray(log_u)), tbatch)
        want.append([bool(info.accepted), int(info.rounds), int(info.n_evaluated)])
        got.append([bool(tinfo.accepted), int(tinfo.rounds), int(tinfo.n_evaluated)])
        np.testing.assert_allclose(float(tinfo.mu_hat), float(info.mu_hat), rtol=1e-4, atol=1e-5)
    assert got == want and 0 < sum(g[0] for g in got) < len(got)


def test_moe_capacity_couples_sections_in_both_packages():
    """A section's log-likelihood under MoE depends on the sections beside it
    in its forward: the capacity is per chunk, so an assignment dropped in
    a round of 4 rows is kept when its row runs alone. Both packages agree
    on each arrangement (1e-5 relative), and in both the 4-row round differs
    from the rows alone where the round dropped assignments (reduced
    mixtral, 4 x 16 tokens: 4 of 240 dropped). This is why the lazy cache's
    reuse of l_i(theta) is exact only where nothing was dropped."""
    name = "mixtral-8x22b"
    jcfg, cfg = j_reduce(J_ARCHS[name]), reduce_config(ARCHS[name])
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), j_init(jax.random.key(0), jcfg))
    tp = _port(jp)
    tok = np.random.default_rng(3).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    with record_moe_drops() as log:
        whole = forward_loglik(tp, {"tokens": torch.tensor(tok)}, cfg).numpy()
    assert int(sum(int(d) for _, d in log)) > 0
    alone = np.array([forward_loglik(tp, {"tokens": torch.tensor(tok[i:i + 1])}, cfg).numpy()[0]
                      for i in range(4)])
    j_whole = np.asarray(j_loglik(jp, {"tokens": jnp.asarray(tok)}, jcfg))
    j_alone = np.array([float(j_loglik(jp, {"tokens": jnp.asarray(tok[i:i + 1])}, jcfg)[0])
                        for i in range(4)])
    np.testing.assert_allclose(whole, j_whole, rtol=1e-5)
    np.testing.assert_allclose(alone, j_alone, rtol=1e-5)
    assert np.abs(whole - alone).max() > 1e-3 and np.abs(j_whole - j_alone).max() > 1e-3


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_serve_lm_decodes_whisper_with_frames_on_cpu(capsys):
    """``--workload lm --arch whisper-base --reduced --device cpu`` prints
    both lines; the frames are 0.1 N(0, 1) in bf16 of (batch, frames, D)
    and the prefill's cache keeps the encoder's output."""
    args = serve.build_parser().parse_args(
        ["--workload", "lm", "--arch", "whisper-base", "--reduced", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    out = {}
    assert serve.serve_lm(args, out) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("prefill 2x8: ") and lines[-1].startswith("decode 4 steps: ")
    frames = out["extra"]["frames"]
    assert frames.dtype == torch.bfloat16 and tuple(frames.shape) == (2, 16, 64)
    assert 0.07 < float(frames.float().std()) < 0.13
    assert tuple(out["cache0"]["enc_out"].shape) == (2, 16, 64)
    assert bool(torch.isfinite(out["prefill_logits"]).all())


def test_train_launcher_runs_moe_and_both_packages_refuse_whisper(tmp_path, monkeypatch):
    """``launch.train --arch mixtral-8x22b --reduced --device cpu --steps 2``
    runs; ``--arch whisper-base`` is refused by both packages' launchers:
    the token stream carries no frames (the port: a ValueError naming them;
    the reference: its forward reads ``extra["frames"]`` of None)."""
    out = train.main(["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", "--steps", "2",
                      "--batch", "8", "--seq", "12", "--ckpt-dir", str(tmp_path / "a")])
    assert len(out["infos"]) == 2 and out["step"] == 1
    with pytest.raises(ValueError, match="frame"):
        train.main(["--arch", "whisper-base", "--reduced", "--device", "cpu", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "b")])
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "whisper-base", "--reduced",
                                      "--steps", "1", "--ckpt-dir", str(tmp_path / "c")])
    with pytest.raises(TypeError):
        j_train.main()


def test_convert_carries_the_new_trees_bit_for_bit():
    """``convert.lm_params`` and ``lm_cache`` carry whisper's ``enc``
    subtree, the stacked expert leaves, the hybrid cache's bf16 ``conv`` and
    float32 ``ssm`` and the audio cache's ``enc_out`` across: every leaf in
    its own dtype, every bit kept."""
    rng = np.random.default_rng(8)
    for name in ("whisper-base", "jamba-v0.1-52b"):
        jcfg = j_reduce(J_ARCHS[name])
        jp = j_init(jax.random.key(1), jcfg)  # bf16, as the reference draws them
        tok = jnp.asarray(rng.integers(0, jcfg.vocab, (2, 6)), jnp.int32)
        extra = None
        if jcfg.family == "audio":
            extra = {"frames": 0.1 * jax.random.normal(
                jax.random.key(2), (2, jcfg.n_audio_frames, jcfg.d_model), jnp.bfloat16)}
        jcache, _ = j_prefill(jp, tok, jcfg, 12, extra)
        tp = _port(jp)
        tcache = convert.lm_cache(jax.tree.map(np.asarray, jcache), device="cpu")
        for j, t in zip(_leaves_of(jp) + _leaves_of(jcache), _leaves_of(tp) + _leaves_of(tcache)):
            a = np.asarray(j)
            assert str(t.dtype).split(".")[-1] == a.dtype.name and tuple(t.shape) == a.shape
            if a.dtype.kind in "iu":
                assert np.array_equal(t.numpy(), a)
            else:
                assert np.array_equal(t.view(torch.int16 if a.itemsize == 2 else torch.int32)
                                      .numpy(), a.view(np.int16 if a.itemsize == 2 else np.int32))
        if name == "jamba-v0.1-52b":
            assert tcache["conv"].dtype == torch.bfloat16 and tcache["ssm"].dtype == torch.float32
            assert tp["layers"]["moe"]["wi_gate"].shape[:3] == (1, 4, 4)
        else:
            assert tcache["enc_out"].dtype == torch.bfloat16 and "enc" in tp


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves_of(tree[k])]
    return [tree]
