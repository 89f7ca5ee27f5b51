"""``repro_torch.launch.dryrun`` (the dry run on the meta device) against
the reference's rules and an independent count.

Every architecture runs at full width on tiny shapes registered in the
port's ``SHAPES`` only, over the production meshes of 256 and 512 meta
slots. A record's ``argument_bytes`` / ``output_bytes`` equal the
reference's per-device sizing, ``sum(leaf bytes / shard count)`` from its
``resolve_spec``; skipped cells carry the reference's reason; a dense cell's
``flops_home`` equals a count from the config's shapes (every projection,
both attention products, the unembedding) to 1e-9 relative: FlopCounterMode
counts 2 m n k a matmul, exactly.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import shape_applicable as j_shape_applicable
from repro.distributed import sharding as j_sharding
from repro.models import transformer as j_tf
from repro_torch import configs
from repro_torch.configs import ARCHS, ShapeSpec
from repro_torch.launch import dryrun

torch.set_num_threads(1)

TINY = {"tiny_prefill": ShapeSpec("tiny_prefill", 8, 2, "prefill"),
        "tiny_decode": ShapeSpec("tiny_decode", 16, 2, "decode"),
        "tiny_train": ShapeSpec("tiny_train", 8, 8, "train")}


@pytest.fixture(autouse=True)
def tiny_shapes(monkeypatch):
    for name, spec in TINY.items():
        monkeypatch.setitem(configs.SHAPES, name, spec)


def _mesh_shape(multi_pod):
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def _ref_bytes(leaves, multi_pod) -> int:
    """The reference's per-device bytes: each leaf's bytes over its shard
    count under ``resolve_spec`` (a stand-in with the mesh's shape)."""
    mesh = type("Standin", (), {"shape": _mesh_shape(multi_pod)})()
    total = 0
    for shape, logical, dtype in leaves:
        spec = j_sharding.resolve_spec(shape, logical, mesh, j_sharding.DEFAULT_RULES)
        shards = 1
        for part in spec:
            for axis in (() if part is None else (part,) if isinstance(part, str) else part):
                shards *= mesh.shape[axis]
        total += int(np.prod(shape, dtype=np.int64)) * jnp.dtype(dtype).itemsize // shards
    return total


def _ref_param_leaves(cfg):
    import jax

    specs = jax.tree.leaves(j_tf.param_specs(cfg), is_leaf=lambda x: isinstance(x, j_tf.ParamSpec))
    return [(s.shape, s.logical, s.dtype) for s in specs]


def _ref_cache_leaves(cfg, gb, s):
    import jax

    specs = jax.tree.leaves(j_tf.cache_template(cfg, gb, s),
                            is_leaf=lambda x: isinstance(x, j_tf.ParamSpec))
    return [(p.shape, p.logical, p.dtype) for p in specs]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_run_cell_every_arch(arch):
    """A prefill cell at full width on the single-pod mesh: ok, its sizes
    the reference's, its trips the reference's scan trip count."""
    spec = TINY["tiny_prefill"]
    rec = dryrun.run_cell(arch, "tiny_prefill", False, "")
    assert rec["status"] == "ok", rec.get("trace")
    cfg = J_ARCHS[arch]
    gb, s = spec.global_batch, spec.seq_len
    inputs = _ref_param_leaves(cfg) + [((gb, s), ("batch", None), jnp.int32)]
    if cfg.family == "audio":
        inputs.append(((gb, cfg.n_audio_frames, cfg.d_model), ("batch", None, None),
                       jnp.bfloat16))
    assert rec["memory"]["argument_bytes"] == _ref_bytes(inputs, False)
    outputs = _ref_cache_leaves(cfg, gb, s) + [((gb, cfg.vocab), ("batch", "vocab"),
                                                jnp.float32)]
    assert rec["memory"]["output_bytes"] == _ref_bytes(outputs, False)
    assert rec["memory"]["alias_bytes"] is None and rec["memory"]["temp_bytes"] > 0
    assert rec["loop_scale"] == _ref_scan_trip_count(cfg) and rec["n_chips"] == 256
    assert rec["flops_home"] > 0 and rec["transfers"]["gather"]["count"] > 0
    assert rec["params_total"] == ARCHS[arch].param_count()


def _ref_scan_trip_count(cfg) -> int:
    """``repro.launch.dryrun.scan_trip_count`` (src/repro/launch/dryrun.py:34),
    restated: importing that module forces 512 host devices on JAX."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_period
    if cfg.family == "ssm":
        return cfg.n_layers // 2
    return cfg.n_layers


@pytest.mark.parametrize("cached", [False, True])
def test_train_cell_on_the_multi_pod_mesh(cached):
    """A train cell (one round's device work; the cached step's cache among
    the inputs) on 512 slots: the batch and cache split over (pod, data),
    the sizes the reference's; theta' is written once (scatter bytes), and
    read whole by the proposal and both priors (gather bytes at least three
    times the parameters')."""
    arch = "xlstm-350m"
    cfg = J_ARCHS[arch]
    spec = TINY["tiny_train"]
    rec = dryrun.run_cell(arch, "tiny_train", True, "", cached=cached)
    assert rec["status"] == "ok", rec.get("trace")
    gb, s = spec.global_batch, spec.seq_len
    inputs = _ref_param_leaves(cfg) + [((), (), jnp.uint32)] + [
        ((gb, s), ("batch", None), jnp.int32)] * 2
    if cached:
        inputs += [((gb,), ("batch",), jnp.float32), ((gb,), ("batch",), jnp.bool_)]
    assert rec["memory"]["argument_bytes"] == _ref_bytes(inputs, True)
    assert rec["n_chips"] == 512 and rec["train_round_batch"] == 2
    param_bytes = 2 * ARCHS[arch].param_count()
    assert rec["transfers"]["scatter"]["bytes"] == param_bytes
    assert rec["transfers"]["gather"]["bytes"] >= 3 * param_bytes


def test_skipped_cells_carry_the_reference_reason(tmp_path):
    for arch in ARCHS:
        ok, reason = j_shape_applicable(arch, "long_500k")
        if ok:
            continue
        rec = dryrun.run_cell(arch, "long_500k", False, str(tmp_path))
        assert rec == {**rec, "status": "skipped", "reason": reason}
        with open(tmp_path / f"{arch}__long_500k__single.json") as f:
            assert json.load(f)["reason"] == reason


def _dense_flops(cfg, b, s, keys, unembed_rows):
    """Matmul flops of a dense forward over ``b x s`` tokens attending over
    ``keys`` positions: q, k, v, o projections, QK^T and PV, the SwiGLU
    MLP's three matmuls, all layers; the unembedding over ``unembed_rows``."""
    t = b * s
    hd, nh, nk = cfg.hd, cfg.n_heads, cfg.n_kv
    proj = 2 * t * cfg.d_model * (nh + 2 * nk) * hd + 2 * t * nh * hd * cfg.d_model
    attn = 2 * (2 * b * nh * s * keys * hd)
    mlp = 3 * 2 * t * cfg.d_model * cfg.d_ff
    return cfg.n_layers * (proj + attn + mlp) + 2 * unembed_rows * cfg.d_model * cfg.vocab


@pytest.mark.parametrize("shape", ["tiny_prefill", "tiny_decode"])
def test_dense_flops_match_an_independent_count(shape):
    cfg = ARCHS["chatglm3-6b"]
    spec = TINY[shape]
    rec = dryrun.run_cell("chatglm3-6b", shape, False, "")
    assert rec["status"] == "ok", rec.get("trace")
    b = spec.global_batch
    if spec.kind == "prefill":  # keys: the prompt itself; logits of the last position
        want = _dense_flops(cfg, b, spec.seq_len, spec.seq_len, b)
    else:  # one token against the whole ring
        want = _dense_flops(cfg, b, 1, spec.seq_len, b)
    assert abs(rec["flops_home"] - want) <= 1e-9 * want, (rec["flops_home"], want)


def test_cut_loops_match_a_whole_trace(monkeypatch):
    """The time and flash cuts give a whole trace's flops exactly (the loops'
    trips are alike) and its temp bytes within 10% (a first-order
    extrapolation): an xLSTM prefill of 80 steps (cut at 16 and 32) and a
    flash prefill of 2 560 rows (10 query chunks, cut at 2 and 4)."""
    from repro_torch.configs import reduce_config
    from repro_torch.launch import steps

    cases = [(reduce_config(ARCHS["xlstm-350m"]), ShapeSpec("x", 80, 2, "prefill")),
             (reduce_config(ARCHS["chatglm3-6b"]), ShapeSpec("f", 2560, 1, "prefill"))]
    for cfg, spec in cases:
        cfg = dryrun.cut_depth(cfg, 1)
        cut = dryrun.trace_cell(steps.cell_for(cfg, spec))
        monkeypatch.setattr(dryrun, "TIME_CUT", 1 << 20)
        monkeypatch.setattr(dryrun, "FLASH_CUT", 1 << 20)
        whole = dryrun.trace_cell(steps.cell_for(cfg, spec))
        monkeypatch.undo()
        assert cut["flops"] == whole["flops"], cfg.name
        assert abs(cut["temp"] - whole["temp"]) <= 0.1 * whole["temp"], (cut, whole)


def test_main_writes_records_and_fails_on_an_error(tmp_path, monkeypatch, capsys):
    dryrun.main(["--arch", "xlstm-350m", "--shape", "tiny_decode", "--mesh", "both",
                 "--out", str(tmp_path), "--tag", "t"])
    for mesh in ("single", "multi"):
        with open(tmp_path / f"xlstm-350m__tiny_decode__{mesh}__t.json") as f:
            assert json.load(f)["status"] == "ok"
    assert capsys.readouterr().out.count("[ok     ] xlstm-350m x tiny_decode") == 2

    def broken(cell):
        raise RuntimeError("no such op")

    monkeypatch.setattr(dryrun, "trace_cell", broken)
    with pytest.raises(SystemExit, match="1 cell"):
        dryrun.main(["--arch", "xlstm-350m", "--shape", "tiny_decode", "--out", ""])
    rec = dryrun.run_cell("xlstm-350m", "tiny_decode", False, "")
    assert rec["status"] == "error" and "no such op" in rec["error"]
