"""``repro_torch.launch.steps`` and ``make_production_mesh`` against the
reference's ``repro.launch.steps`` and ``repro.distributed.sharding``.

The port's input specs are meta tensors; their shapes and dtypes are held
to the reference's ``ShapeDtypeStruct``s leaf by leaf for every (arch x
shape) cell. Under the production meshes (512 meta slots forced in this
process) every parameter, batch and cache leaf's ``PartitionSpec`` is held
to the reference's ``resolve_spec`` on a stand-in whose ``.shape`` is the
mesh's dict (all it reads). A cell's step run on real CPU tensors split by
its ``in_shardings`` is held to the same cell without a mesh, bit for bit.
"""
import dataclasses
import types

import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.distributed import sharding as j_sharding
from repro.launch import steps as j_steps
from repro.models import transformer as j_tf
from repro_torch._device import tree_leaves
from repro_torch.bayes import LogLikCache, TrainConfig
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, reduce_config
from repro_torch.distributed import ShardedTensor, force_devices, gather_params
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh_for_devices, make_production_mesh
from repro_torch.models import init_params

torch.set_num_threads(1)


def _flat(tree, prefix=()):
    """{path: leaf} with dict keys sorted, tuple fields by index, Nones left
    out; the same for both packages' trees."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)) and not isinstance(tree, j_sharding.P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    return {} if tree is None else {prefix: tree}


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_match_reference(arch):
    """Every shape's inputs: the same leaves, shapes and dtypes."""
    for shape in SHAPES:
        want = _flat(j_steps.input_specs(arch, shape))
        got = _flat(steps.input_specs(arch, shape))
        assert set(got) == set(want), (arch, shape)
        for path, ref in want.items():
            t = got[path]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref.shape), (arch, shape, path)
            assert _dtype(t) == str(ref.dtype), (arch, shape, path)


def _ref_logical(cfg_ref, spec, cached):
    """The reference's logical names of a cell's inputs, by the port's paths."""
    gb, s = spec.global_batch, spec.seq_len
    params = j_tf.param_specs(cfg_ref)
    if spec.kind == "train":
        batch = {"tokens": j_tf.ParamSpec((gb, s), ("batch", None)),
                 "mask": j_tf.ParamSpec((gb, s), ("batch", None))}
        if cfg_ref.family == "audio":
            batch["frames"] = j_tf.ParamSpec((gb, cfg_ref.n_audio_frames, cfg_ref.d_model),
                                             ("batch", None, None))
        tree = (j_tf.ParamSpec((), ()), params, batch)
        if cached:
            tree += ((j_tf.ParamSpec((gb,), ("batch",)), j_tf.ParamSpec((gb,), ("batch",))),)
    elif spec.kind == "prefill":
        tree = (params, j_tf.ParamSpec((gb, s), ("batch", None)))
        if cfg_ref.family == "audio":
            tree += (j_tf.ParamSpec((gb, cfg_ref.n_audio_frames, cfg_ref.d_model),
                                    ("batch", None, None)),)
    else:
        cache = j_tf.cache_template(cfg_ref, gb, s)
        tree = (params, cache, j_tf.ParamSpec((gb, 1), ("batch", None)))
    return _flat(tree)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_partition_specs_match_reference(multi_pod):
    """Under the production mesh of 256 or 512 meta slots, every input
    leaf's PartitionSpec is the reference's resolve_spec, for every cell
    (the cached train step's cache too) and every rule preset on jamba's
    decode_32k; fewer slots than the mesh needs raise, as jax.make_mesh."""
    with force_devices(512):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        assert mesh.size == (512 if multi_pod else 256)
        assert mesh.axis_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
        standin = types.SimpleNamespace(shape=mesh.shape)
        cases = [(a, s, "default", False) for a in ARCHS for s in SHAPES]
        cases += [("chatglm3-6b", "train_4k", "default", True)]
        cases += [("jamba-v0.1-52b", "decode_32k", r, False) for r in steps.RULE_PRESETS]
        for arch, shape, preset, cached in cases:
            rules = steps.RULE_PRESETS[preset]
            tc = None
            if cached:
                tc = dataclasses.replace(steps.default_train_config(ARCHS[arch], SHAPES[shape]),
                                         cached=True)
            cell = steps.build_cell(arch, shape, mesh, train_cfg=tc, rules=rules)
            got = _flat(cell.in_shardings)
            want = _ref_logical(J_ARCHS[arch], SHAPES[shape], cached)
            assert set(got) == set(want), (arch, shape)
            j_rules = dict(j_sharding.DEFAULT_RULES, **(rules or {}))
            for path, ps in want.items():
                ref = j_sharding.resolve_spec(ps.shape, ps.logical, standin, j_rules)
                assert tuple(got[path].spec) == tuple(ref), (arch, shape, preset, path)
    with pytest.raises(ValueError, match="needs 256 slots"):
        make_production_mesh(device="cpu")


def test_rule_presets_and_train_config_match_reference():
    assert steps.RULE_PRESETS == j_steps.RULE_PRESETS
    for arch in ARCHS:
        for shape in SHAPES:
            want = j_steps.default_train_config(J_ARCHS[arch], SHAPES[shape])
            got = steps.default_train_config(ARCHS[arch], SHAPES[shape])
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cell = steps.build_cell("chatglm3-6b", "train_4k",
                            train_cfg=TrainConfig(round_batch=64, cached=True))
    assert cell.donate_argnums == (1, 3) and len(cell.in_specs) == 4
    assert isinstance(cell.in_specs[3], LogLikCache)


_TINY = {"train": ShapeSpec("tiny_train", 12, 8, "train"),
         "prefill": ShapeSpec("tiny_prefill", 8, 2, "prefill"),
         "decode": ShapeSpec("tiny_decode", 16, 2, "decode")}


def _real_inputs(cell, cfg):
    """Real CPU tensors for the cell's inputs: parameters from seed 0, the
    rest drawn from a seeded generator (a decode cache from a prefill)."""
    gen = torch.Generator().manual_seed(3)
    params = init_params(0, cfg, device="cpu")
    spec = cell.spec
    gb, s = spec.global_batch, spec.seq_len
    tokens = torch.randint(0, cfg.vocab, (gb, s), generator=gen, dtype=torch.int32)
    if spec.kind == "train":
        batch = {"tokens": tokens, "mask": torch.ones_like(tokens)}
        args = (5, params, batch)
        if cell.train_cfg.cached:
            args += (LogLikCache(torch.zeros(gb), torch.zeros(gb, dtype=torch.bool)),)
        return args
    if spec.kind == "prefill":
        return params, tokens
    from repro_torch.models import prefill

    cache, _ = prefill(params, tokens[:, :4], cfg, s)
    return params, cache, tokens[:, :1]


@pytest.mark.parametrize("kind", ["train", "cached", "prefill", "decode"])
def test_cell_step_sharded_equals_unsharded(kind):
    """A ``cell_for`` step on real CPU tensors placed by its in_shardings
    on a (2, 2) mesh of CPU slots, against the cell with no mesh: every
    output equal bit for bit (``TrainConfig.cached`` builds the cached
    step: three outputs, the cache's values among them)."""
    cfg = reduce_config(ARCHS["chatglm3-6b"])
    spec = _TINY["train" if kind == "cached" else kind]
    tc = None
    if spec.kind == "train":
        tc = TrainConfig(round_batch=4, epsilon=0.05, sigma=1e-3, ce_chunk=8,
                         cached=kind == "cached")
    plain = steps.cell_for(cfg, spec, None, tc)
    want = plain.step(*steps.place_inputs(plain, *_real_inputs(plain, cfg)))
    with force_devices(4):
        mesh = make_mesh_for_devices(model_parallel=2, device="cpu")
        cell = steps.cell_for(cfg, spec, mesh, tc)
        placed = steps.place_inputs(cell, *_real_inputs(cell, cfg))
        assert all(isinstance(l, ShardedTensor) for l in tree_leaves(placed[1]))
        got = cell.step(*placed)
    if kind == "cached":
        assert len(got) == 3 and isinstance(got[1], LogLikCache)
    if spec.kind == "train":
        assert all(isinstance(l, ShardedTensor) for l in tree_leaves(got[0]))
    got_l, want_l = tree_leaves(gather_params(got)), tree_leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b)
