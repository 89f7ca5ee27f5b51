"""The LM's sharded parameters on the port's slot mesh
(``distributed.sharding.ShardedTensor``, ``shard_params``, ``shard_batch``,
``checkpoint.restore(shardings=)``, ``--model-parallel`` in ``launch.train``)
against the unsharded port and the reference's rules.

Four (or eight) CPU slots are forced in this process
(``force_devices``). Pieces live on the slots, compute on the home device,
so a sharded step is held to the unsharded one bit for bit: every decision,
round, ``n_evaluated`` and parameter. That is stricter than the reference's
own sharded-against-single test (``tests/test_distributed.py``: the accept
decision equal, the parameters within 2e-2).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.distributed import sharding as j_sharding
from repro_torch._device import tree_leaves
from repro_torch.bayes import (LogLikCache, TrainConfig, make_cached_train_step,
                               make_exact_step, make_train_step)
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import ARCHS, reduce_config
from repro_torch.data import DataConfig, MarkovStream, TokenStream, shard_batch
from repro_torch.distributed import (ShardedTensor, force_devices, gather_params,
                                     logical_axis_rules, named_sharding, shard_params)
from repro_torch.distributed import sharding
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.launch.steps import spec_tree_to_shardings
from repro_torch.models import decode_step, init_params, param_specs, prefill
from repro_torch.runtime import InjectedFailure, LoopConfig, run_loop
from repro_torch.runtime.train_loop import step_generator

torch.set_num_threads(1)

TC = TrainConfig(round_batch=4, epsilon=0.05, sigma=1e-3)


def _mesh(data: int, model: int):
    return make_mesh_for_devices(data * model, model_parallel=model, device="cpu")


def _same(a, b) -> bool:
    la, lb = tree_leaves(gather_params(a)), tree_leaves(gather_params(b))
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _falls_through(cfg, mesh) -> list[str]:
    """Leaves with a dim whose rule names a mesh axis that does not divide
    it, so the dim is replicated (the reference's fallback)."""
    out = []
    flat = {}

    def walk(t, p=""):
        for k, v in t.items():
            walk(v, f"{p}/{k}") if isinstance(v, dict) else flat.__setitem__(f"{p}/{k}", v)

    walk(param_specs(cfg))
    for path, s in flat.items():
        spec = list(sharding.resolve_spec(s.shape, s.logical, mesh, sharding.DEFAULT_RULES))
        spec += [None] * (len(s.shape) - len(spec))
        for dim, name, got in zip(s.shape, s.logical, spec):
            cands = [c for c in sharding.DEFAULT_RULES.get(name or "", ())
                     if all(a in mesh.shape for a in c)]
            if got is None and cands and dim % int(np.prod([mesh.shape[a] for a in cands[0]])):
                out.append(path)
    return out


# ---------------------------------------------------------------------------
# The sharded leaf
# ---------------------------------------------------------------------------


def test_sharded_leaf_reads_writes_and_counts():
    """gather, a row, rows, write_rows, the address kept modulo 64 bytes,
    and the transfer counters; a (2, 2) split over a stacked leaf's embed and
    heads dims with the layers axis replicated."""
    with force_devices(4):
        mesh = _mesh(2, 2)
        full = torch.arange(3 * 8 * 4 * 2 * 2, dtype=torch.float32).reshape(3 * 8 * 4 * 2 * 2)
        x = full[2:2 + 3 * 8 * 4 * 2].reshape(3, 8, 4, 2)  # a view 8 bytes past its base
        sh = named_sharding(mesh, x.shape, ("layers", "embed", "q_heads", None))
        assert tuple(sh.spec) == (None, "data", "model")
        sharding.reset_transfers()
        st = ShardedTensor.from_tensor(x, sh)
        assert len(st.pieces) == 4 and all(p.shape == (3, 4, 2, 2) for p in st.pieces)
        assert st.device == torch.device("cpu") and st.shape == x.shape and st.ndim == 4
        assert sharding.transfer_counts()["scatter"] == {"count": 1, "bytes": x.numel() * 4}
        g = st.gather()
        assert torch.equal(g, x) and g.data_ptr() % 64 == x.data_ptr() % 64
        for i in range(3):
            row = st[i]
            assert torch.equal(row, x[i]) and row.data_ptr() % 64 == x[i].data_ptr() % 64
        assert torch.equal(st.rows(1, 3), x[1:3])
        assert st.row_bounds(64) == [(0, 1), (1, 2), (2, 3)]
        assert st.row_bounds(1 << 20) == [(0, 3)]
        counts = sharding.transfer_counts()
        assert counts["gather"]["count"] == 5
        assert counts["gather"]["bytes"] == x.numel() * 4 + 3 * x[0].numel() * 4 + 2 * x[0].numel() * 4
        new = st.empty_like()
        new.write_rows(0, 3, x * 2)
        assert torch.equal(new.gather(), x * 2)
        assert {b.slot for b in st.blocks} == {(0, 0), (0, 1), (1, 0), (1, 1)}
        # a replicated leaf: one owner, slot (0, 0)
        y = torch.ones(5)
        rep = ShardedTensor.from_tensor(y, named_sharding(mesh, y.shape, (None,)))
        assert [b.slot for b in rep.blocks] == [(0, 0)] and torch.equal(rep.gather(), y)
        with pytest.raises(TypeError, match="int row"):
            st[0:1]


def test_shard_params_and_batch_round_trip():
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    params = init_params(0, cfg, device="cpu")
    batch = TokenStream(DataConfig(cfg.vocab, 8, 8, 0), device="cpu").batch(0)
    with force_devices(4):
        mesh = _mesh(2, 2)
        sp = shard_params(params, mesh, specs=param_specs(cfg))
        assert all(isinstance(l, ShardedTensor) for l in tree_leaves(sp))
        assert _same(sp, params)
        table = sp["embed"]["table"]
        assert tuple(table.sharding.spec) == ("model",)
        sb = shard_batch(batch, mesh)
        assert tuple(sb["tokens"].sharding.spec) == ("data",)
        assert torch.equal(sb["tokens"].rows(2, 6), batch["tokens"][2:6])
        # the reference's shard_batch spec on the same mesh shape
        want = j_sharding.resolve_spec(batch["tokens"].shape, ("batch", None), mesh,
                                       j_sharding.DEFAULT_RULES)
        assert tuple(sb["tokens"].sharding.spec) == tuple(want)


# ---------------------------------------------------------------------------
# Sharded steps bit for bit
# ---------------------------------------------------------------------------


def _chain(cfg, kind, params, steps=4, batch_fn=None, sharded_batch=None):
    maker = {"plain": make_train_step, "exact": make_exact_step}.get(kind)
    batch_fn = batch_fn or MarkovStream(DataConfig(cfg.vocab, 12, 8, seed=0), device="cpu").batch
    infos, caches = [], []
    if kind == "cached":
        step = make_cached_train_step(cfg, dataclasses.replace(TC, cached=True))
        cache = LogLikCache.empty(8, device="cpu")
    else:
        step = maker(cfg, TC)
    for s in range(steps):
        batch = batch_fn(s)
        if sharded_batch is not None:
            batch = shard_batch(batch, sharded_batch)
        gen = step_generator(0, s, "cpu")
        if kind == "cached":
            params, cache, info = step(gen, params, batch, cache)
            caches.append(cache)
        else:
            params, info = step(gen, params, batch)
        infos.append(info)
    return params, infos, caches


_STEP_CASES = [("chatglm3-6b", mesh, kind) for mesh in ((2, 2), (1, 4))
               for kind in ("plain", "exact", "cached")]
_STEP_CASES += [(arch, (1, 4), "plain") for arch in ("gemma3-4b", "mixtral-8x22b",
                                                      "xlstm-350m")]


def _cfg(arch):
    cfg = reduce_config(ARCHS[arch])
    if arch == "xlstm-350m":  # 2 heads: the q_heads dims do not split over model = 4
        cfg = dataclasses.replace(cfg, n_heads=2)
    return cfg


@pytest.mark.parametrize("arch,shape,kind", _STEP_CASES)
def test_sharded_step_equals_unsharded(arch, shape, kind):
    """The plain, exact and cached steps on sharded parameters (and a
    sharded batch): every info field, every cache and every parameter equal
    the unsharded chain's bit for bit, with some proposals accepted. On
    (1, 4) the configs whose counts do not divide the model axis keep a leaf
    replicated (the rules' fallback)."""
    cfg = _cfg(arch)
    params = init_params(0, cfg, device="cpu")
    want, want_infos, want_caches = _chain(cfg, kind, params)
    with force_devices(4):
        mesh = _mesh(*shape)
        if arch != "chatglm3-6b":
            assert _falls_through(cfg, mesh), arch
        with logical_axis_rules(mesh):
            got, infos, caches = _chain(cfg, kind, shard_params(params, mesh,
                                                                specs=param_specs(cfg)),
                                        sharded_batch=mesh)
    assert all(isinstance(l, ShardedTensor) for l in tree_leaves(got))
    assert _same(got, want)
    for a, b in zip(infos, want_infos):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for a, b in zip(caches, want_caches):
        assert torch.equal(a.ll, b.ll) and torch.equal(a.valid, b.valid)
    if kind != "exact":
        assert any(bool(i.accepted) for i in want_infos) or arch != "chatglm3-6b"


def test_mala_over_sharded_parameters_equals_unsharded():
    """A MALA step over parameters sharded on (2, 2): the new parameters
    (sharded leaves) and every info field the unsharded step's, bit for bit
    (tests/test_torch_mala_mesh.py holds each gradient and theta' too)."""
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    batch = TokenStream(DataConfig(cfg.vocab, 8, 4, 1), device="cpu").batch(0)
    params = init_params(0, cfg, device="cpu")
    step = make_train_step(cfg, TrainConfig(proposal="mala"))
    want, want_info = step(torch.Generator().manual_seed(0), params, batch)
    with force_devices(4):
        mesh = _mesh(2, 2)
        sp = shard_params(params, mesh, specs=param_specs(cfg))
        got, info = step(torch.Generator().manual_seed(0), sp, batch)
    assert all(isinstance(l, ShardedTensor) for l in tree_leaves(got))
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for a, b in zip(tree_leaves(gather_params(got)), tree_leaves(want)):
        assert torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))
    for a, b in zip(info, want_info):
        assert torch.equal(a.view(ints[a.dtype]) if a.is_floating_point() else a,
                           b.view(ints[b.dtype]) if b.is_floating_point() else b)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["chatglm3-6b", "whisper-base", "jamba-v0.1-52b",
                                  "xlstm-350m"])
def test_prefill_and_decode_sharded(arch):
    """Prefill and 4 decode steps from sharded parameters: every cache leaf
    and every logit equal the unsharded run's bit for bit (whisper reads
    its encoder's positions and norm and the decoder's positions whole)."""
    cfg = reduce_config(ARCHS[arch])
    params = init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (2, 6), generator=gen, dtype=torch.int32)
    extra = None
    if cfg.family == "audio":
        extra = {"frames": 0.1 * torch.randn((2, cfg.n_audio_frames, cfg.d_model), generator=gen,
                                             dtype=torch.bfloat16)}

    def run(p):
        cache, logits = prefill(p, prompts, cfg, 16, extra)
        out = [logits]
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        for _ in range(4):
            cache, logits = decode_step(p, cache, tok, cfg)
            out.append(logits)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        return cache, out

    want_cache, want = run(params)
    with force_devices(4):
        mesh = _mesh(2, 2)
        with logical_axis_rules(mesh):
            cache, got = run(shard_params(params, mesh, specs=param_specs(cfg)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache), tree_leaves(want_cache)))


# ---------------------------------------------------------------------------
# The launcher, the loop and the checkpoint
# ---------------------------------------------------------------------------


def _files(d):
    step = ckpt.latest_step(d)
    path = os.path.join(d, f"step_{step:010d}")
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


def test_launch_train_model_parallel_equals_one(tmp_path):
    """``launch.train --model-parallel 2 --devices 4`` (a 2 x 2 mesh of CPU
    slots) against ``--model-parallel 1`` on one slot: every step's info and
    every final parameter equal, and the checkpoints' files byte for byte."""
    argv = ["--reduced", "--device", "cpu", "--steps", "5", "--batch", "8", "--seq", "12",
            "--sigma", "1e-3"]
    one = train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    two = train.main(argv + ["--ckpt-dir", str(tmp_path / "two"), "--model-parallel", "2",
                             "--devices", "4"])
    assert all(isinstance(l, ShardedTensor) for l in tree_leaves(two["params"]))
    assert _same(two["params"], one["params"])
    assert len(one["infos"]) == len(two["infos"]) == 5
    for a, b in zip(one["infos"], two["infos"]):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert any(bool(i["accepted"]) for i in one["infos"])
    assert _files(tmp_path / "two") == _files(tmp_path / "one")
    with pytest.raises(ValueError, match="model=2"):  # one CPU slot does not split in two
        train.main(argv + ["--ckpt-dir", str(tmp_path / "x"), "--model-parallel", "2"])


def test_run_loop_resumes_sharded(tmp_path):
    """A sharded chain stopped by an injected failure and resumed from its
    checkpoint (restored onto the target's shardings) ends where the chain
    run without a stop ends, bit for bit."""
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    step = make_train_step(cfg, TC)
    stream = MarkovStream(DataConfig(cfg.vocab, 12, 8, seed=0), device="cpu")
    params0 = init_params(0, cfg, device="cpu")
    loop = lambda d, **kw: LoopConfig(num_steps=6, ckpt_dir=str(tmp_path / d), ckpt_every=2, **kw)
    clean = run_loop(step, params0, stream.batch, loop("clean"))
    with force_devices(4):
        mesh = _mesh(2, 2)
        sp = shard_params(params0, mesh, specs=param_specs(cfg))
        with pytest.raises(InjectedFailure):
            run_loop(step, sp, stream.batch, loop("crash", fail_at_step=3))
        resumed = run_loop(step, sp, stream.batch, loop("crash"))
    assert len(resumed["infos"]) == 4
    assert all(isinstance(l, ShardedTensor) for l in tree_leaves(resumed["params"]))
    assert _same(resumed["params"], clean["params"])
    for a, b in zip(clean["infos"][2:], resumed["infos"]):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_elastic_checkpoint_reshard_across_meshes(tmp_path):
    """The reference's elastic test: parameters saved sharded on a (4, 2)
    mesh, restored onto (2, 4): the values equal, each piece lies where the
    new shardings put it, and the files are byte for byte an unsharded
    save's."""
    cfg = reduce_config(ARCHS["xlstm-350m"])
    params = init_params(0, cfg, device="cpu")
    ckpt.save(str(tmp_path / "whole"), 3, params)
    with force_devices(8):
        mesh_a = make_mesh_for_devices(8, model_parallel=2, device="cpu")
        ckpt.save(str(tmp_path / "a"), 3, shard_params(params, mesh_a, specs=param_specs(cfg)))
        mesh_b = make_mesh_for_devices(8, model_parallel=4, device="cpu")
        sh_b = spec_tree_to_shardings(param_specs(cfg), mesh_b)
        step, restored = ckpt.restore(str(tmp_path / "a"), target=params, shardings=sh_b)
    assert step == 3
    assert _same(restored, params)
    for leaf, sh, want in zip(tree_leaves(restored), tree_leaves(sh_b), tree_leaves(params)):
        assert isinstance(leaf, ShardedTensor) and leaf.sharding == sh
        for blk, piece in zip(leaf.blocks, leaf.pieces):
            assert blk.index == sh.slot_index(blk.slot, want.shape)
            assert torch.equal(piece, want[blk.index])
    assert _files(tmp_path / "a") == _files(tmp_path / "whole")
    # a sharded target places the restore by its own shardings
    with force_devices(8):
        target = shard_params(params, mesh_b, specs=param_specs(cfg))
        _, again = ckpt.restore(str(tmp_path / "whole"), target=target)
    assert all(a.sharding == b.sharding for a, b in zip(tree_leaves(again), tree_leaves(target)))
    assert _same(again, params)
