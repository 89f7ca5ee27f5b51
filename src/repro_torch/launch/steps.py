"""Step builders and abstract input specs for every (arch x shape) cell: the
port of ``repro.launch.steps``.

:func:`input_specs` gives meta-device stand-ins for every input of a
cell's step (shapes and dtypes, no memory), and :func:`build_cell` the step
with them:

  train_*   : (seed, params, batch[, cache]) -> (params', LMTrainInfo)
              (cached: (params', cache', LMTrainInfo))
  prefill_* : (params, tokens[, frames])     -> (cache, last logits)
  decode_*  : (params, cache, tokens)        -> (cache', logits)

A meta tensor carries no sharding, so under a mesh the layouts are the
parallel trees :func:`spec_tree_to_shardings` builds (``Cell.in_shardings``,
``Cell.out_shardings``), by the reference's rules; :func:`place_inputs`
splits whole inputs by them. A step takes whole or sharded inputs and
computes on their home device: theta' keeps theta's layout, a cache and the
logits come back whole there.

One divergence: a train step's ``seed`` (an int) seeds a ``torch.Generator``
on the parameters' home device through ``_device.make_generator`` (a CPU
generator for meta tensors), where the reference calls
``jax.random.key(seed)``; the bits differ.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._device import make_generator, tree_leaves, tree_map
from ..bayes import LogLikCache, TrainConfig, make_cached_train_step, make_train_step
from ..configs import ARCHS, SHAPES, ShapeSpec
from ..distributed.sharding import gather_params, named_sharding, shard_tree, whole
from ..models.transformer import (
    ModelConfig,
    cache_template,
    decode_step,
    param_specs,
    prefill,
)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def spec_tree_to_abstract(specs, mesh=None, rules=None):
    """ParamSpec tree -> meta-tensor tree. ``mesh`` and ``rules`` are the
    reference's arguments; a meta tensor holds no sharding, so they are read
    by :func:`spec_tree_to_shardings` instead."""
    del mesh, rules
    return tree_map(lambda s: _meta(s.shape, s.dtype), specs)


def spec_tree_to_shardings(specs, mesh, rules=None):
    """ParamSpec tree -> tree of ``NamedSharding`` by the rules."""
    return tree_map(lambda s: named_sharding(mesh, s.shape, s.logical, rules), specs)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    spec: ShapeSpec
    step: Callable
    in_specs: tuple  # meta tensors, one tree an input
    in_shardings: Any  # the inputs' NamedSharding trees under a mesh, else None
    out_shardings: Any
    donate_argnums: tuple = ()
    train_cfg: TrainConfig | None = None
    rules: dict | None = None  # logical-axis rule overrides for this cell


def default_train_config(cfg: ModelConfig, spec: ShapeSpec) -> TrainConfig:
    rb = max(spec.global_batch // 4, 1)
    return TrainConfig(round_batch=rb, epsilon=0.05, sigma=1e-4, ce_chunk=256)


# Rule presets for sharding experiments, the reference's. "infer_tp": weights
# prefer the model axis over data-axis FSDP (decode). "infer_replicate":
# drop the data axis from weights. "mamba_dp": replicate the mamba inner
# projections over the model axis. "jamba_prefill": both of the last two.
RULE_PRESETS: dict[str, dict | None] = {
    "default": None,
    "infer_tp": {"embed": (("model",), ("data",))},
    "infer_replicate": {"embed": ()},
    "mamba_dp": {"mamba_inner": ()},
    "jamba_prefill": {"mamba_inner": (), "embed": ()},
}


def _generator(seed, params) -> torch.Generator:
    """The step's generator, seeded ``seed``, on the parameters' home device
    (the CPU for meta tensors, which no generator lives on)."""
    home = tree_leaves(params)[0].device
    return make_generator(int(whole(seed)), "cpu" if home.type == "meta" else home)


def build_cell(arch: str, shape: str, mesh=None, train_cfg: TrainConfig | None = None,
               rules: dict | None = None, kv_dtype: str | None = None) -> Cell:
    cfg = ARCHS[arch]
    if kv_dtype is not None:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    return cell_for(cfg, SHAPES[shape], mesh, train_cfg, rules, arch=arch)


def cell_for(cfg: ModelConfig, spec: ShapeSpec, mesh=None, train_cfg: TrainConfig | None = None,
             rules: dict | None = None, *, arch: str | None = None) -> Cell:
    """:func:`build_cell` for a given config and shape (the dry run's cut
    depths, a shape of one's own)."""
    arch = arch or cfg.name
    gb, s = spec.global_batch, spec.seq_len
    pspecs = param_specs(cfg)
    params_abs = spec_tree_to_abstract(pspecs, mesh, rules)
    params_sh = spec_tree_to_shardings(pspecs, mesh, rules) if mesh else None

    def sh(shape_, logical):
        return named_sharding(mesh, shape_, logical, rules) if mesh else None

    repl = sh((), ())
    if spec.kind == "train":
        tc = train_cfg or default_train_config(cfg, spec)
        batch_abs = {"tokens": _meta((gb, s), torch.int32), "mask": _meta((gb, s), torch.int32)}
        batch_log = {"tokens": ("batch", None), "mask": ("batch", None)}
        if cfg.family == "audio":
            batch_abs["frames"] = _meta((gb, cfg.n_audio_frames, cfg.d_model), torch.bfloat16)
            batch_log["frames"] = ("batch", None, None)
        batch_sh = ({k: sh(v.shape, batch_log[k]) for k, v in batch_abs.items()}
                    if mesh else None)
        seed_abs = _meta((), torch.uint32)
        if tc.cached:
            raw_step = make_cached_train_step(cfg, tc)

            def step(seed, params, batch, cache):
                whole_cache = LogLikCache(whole(cache.ll), whole(cache.valid), cache.valid_host)
                return raw_step(_generator(seed, params), params, batch, whole_cache)

            cache_abs = LogLikCache(_meta((gb,), torch.float32), _meta((gb,), torch.bool))
            cache_sh = LogLikCache(sh((gb,), ("batch",)), sh((gb,), ("batch",))) if mesh else None
            in_specs = (seed_abs, params_abs, batch_abs, cache_abs)
            in_sh = (repl, params_sh, batch_sh, cache_sh) if mesh else None
            out_sh = (params_sh, cache_sh, None) if mesh else None
            return Cell(arch, spec.name, cfg, spec, step, in_specs, in_sh, out_sh,
                        donate_argnums=(1, 3), train_cfg=tc, rules=rules)

        raw_step = make_train_step(cfg, tc)

        def step(seed, params, batch):
            return raw_step(_generator(seed, params), params, batch)

        in_specs = (seed_abs, params_abs, batch_abs)
        in_sh = (repl, params_sh, batch_sh) if mesh else None
        out_sh = (params_sh, None) if mesh else None
        return Cell(arch, spec.name, cfg, spec, step, in_specs, in_sh, out_sh,
                    donate_argnums=(1,), train_cfg=tc, rules=rules)

    cache_specs = cache_template(cfg, gb, s)
    cache_sh = spec_tree_to_shardings(cache_specs, mesh, rules) if mesh else None
    logits_sh = sh((gb, cfg.vocab), ("batch", "vocab"))
    if spec.kind == "prefill":
        def step(params, tokens, *extra):
            ex = {"frames": whole(extra[0])} if extra else None
            return prefill(params, whole(tokens), cfg, max_len=s, extra=ex)

        extras, extras_sh = (), ()
        if cfg.family == "audio":
            extras = (_meta((gb, cfg.n_audio_frames, cfg.d_model), torch.bfloat16),)
            extras_sh = (sh(extras[0].shape, ("batch", None, None)),)
        in_specs = (params_abs, _meta((gb, s), torch.int32)) + extras
        in_sh = (params_sh, sh((gb, s), ("batch", None))) + extras_sh if mesh else None
        out_sh = (cache_sh, logits_sh) if mesh else None
        return Cell(arch, spec.name, cfg, spec, step, in_specs, in_sh, out_sh, rules=rules)

    # decode: one new token against a seq_len-deep cache
    def step(params, cache, tokens):
        return decode_step(params, gather_params(cache), whole(tokens), cfg)

    in_specs = (params_abs, spec_tree_to_abstract(cache_specs, mesh, rules),
                _meta((gb, 1), torch.int32))
    in_sh = (params_sh, cache_sh, sh((gb, 1), ("batch", None))) if mesh else None
    out_sh = (cache_sh, logits_sh) if mesh else None
    return Cell(arch, spec.name, cfg, spec, step, in_specs, in_sh, out_sh,
                donate_argnums=(1,), rules=rules)


def place_inputs(cell: Cell, *args) -> tuple:
    """``args`` (whole inputs, one an entry of ``cell.in_specs``) split by
    ``cell.in_shardings``; as they are without a mesh."""
    if cell.in_shardings is None:
        return args
    return tuple(shard_tree(a, sh) for a, sh in zip(args, cell.in_shardings))


def input_specs(arch: str, shape: str, mesh=None):
    """The meta-device stand-ins for every model input of the given cell."""
    return build_cell(arch, shape, mesh).in_specs
