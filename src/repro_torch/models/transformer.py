"""Config-driven decoder LM, the dense family: the port of
``repro.models.transformer``.

Parameter trees are nested dicts of tensors; :func:`param_specs` returns the
same tree with :class:`~repro_torch.models.layers.ParamSpec` leaves, so a
caller can count and size a model without allocating it. The stacked layer
axis of the reference (``lax.scan`` over layers) is kept in the tree and
walked by a Python loop.

Entry points: ``param_specs(cfg)``, ``init_params(seed, cfg, device=)``,
``forward_hidden(params, tokens, cfg)`` and ``forward_loglik(params, batch,
cfg)`` (per-sequence log-likelihoods, the local sections of the LM's MH).

The other families (moe, ssm, hybrid, audio, vlm), ``prefill``,
``decode_step`` and the KV caches come with later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from .layers import ParamSpec, attention, embed, init_leaf, rms_norm, swiglu_mlp, unembed_loglik

Params = dict[str, Any]

_LATER = {
    "moe": "the MoE slice",
    "ssm": "the SSM slice",
    "hybrid": "the hybrid slice",
    "audio": "the audio slice",
    "vlm": "the VLM slice",
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_base: float = 10_000.0
    rotary_frac: float = 1.0
    window: int | None = None  # uniform sliding window (mixtral)
    local_window: int | None = None  # gemma3 local layers
    global_every: int | None = None  # gemma3: every k-th layer is global
    global_rope_base: float | None = None
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # jamba/phi: MoE layer cadence
    attn_period: int = 0  # jamba: one attention layer per this many
    attn_index: int = 4
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    dt_rank: int | None = None
    enc_layers: int = 0  # whisper encoder depth
    n_audio_frames: int = 1500
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    max_seq: int = 8192
    sub_quadratic: bool = False  # eligible for long_500k decode
    kv_cache_dtype: str = "bf16"  # "bf16" | "fp8"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dt_rank_eff(self) -> int:
        return self.dt_rank or math.ceil(self.d_model / 16)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def param_count(self) -> int:
        return int(sum(s.numel for s in _flatten(param_specs(self)).values()))


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _rebuild(specs: dict, flat: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in specs.items():
        path = f"{prefix}/{k}" if prefix else k
        out[k] = _rebuild(v, flat, path) if isinstance(v, dict) else flat[path]
    return out


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d, h, nh, nk = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv
    sl = ("layers",) * len(stack)
    s = {
        "wq": ParamSpec(stack + (d, nh, h), sl + ("embed", "q_heads", None)),
        "wk": ParamSpec(stack + (d, nk, h), sl + ("embed", "kv_heads", None)),
        "wv": ParamSpec(stack + (d, nk, h), sl + ("embed", "kv_heads", None)),
        "wo": ParamSpec(stack + (nh, h, d), sl + ("q_heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec(stack + (nh, h), sl + ("q_heads", None), init_scale="zero")
        s["bk"] = ParamSpec(stack + (nk, h), sl + ("kv_heads", None), init_scale="zero")
        s["bv"] = ParamSpec(stack + (nk, h), sl + ("kv_heads", None), init_scale="zero")
    if cfg.qk_norm:
        s["qnorm"] = ParamSpec(stack + (h,), sl + (None,), init_scale="zero")
        s["knorm"] = ParamSpec(stack + (h,), sl + (None,), init_scale="zero")
    return s


def _mlp_specs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    sl = ("layers",) * len(stack)
    return {
        "wi_gate": ParamSpec(stack + (d, f), sl + ("embed", "mlp")),
        "wi_up": ParamSpec(stack + (d, f), sl + ("embed", "mlp")),
        "wo": ParamSpec(stack + (f, d), sl + ("mlp", "embed")),
    }


def _norm_spec(cfg: ModelConfig, stack: tuple = ()) -> ParamSpec:
    return ParamSpec(stack + (cfg.d_model,), ("layers",) * len(stack) + (None,),
                     init_scale="zero")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _LATER:
        raise NotImplementedError(f"the {cfg.family!r} family comes with {_LATER[cfg.family]}")
    if cfg.family != "dense":
        raise ValueError(f"unknown family {cfg.family!r}")


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree with ParamSpec leaves (nothing is allocated)."""
    _check_family(cfg)
    d, v, n = cfg.d_model, cfg.vocab, cfg.n_layers
    return {
        "embed": {"table": ParamSpec((v, d), ("vocab", None), init_scale="embed")},
        "final_norm": _norm_spec(cfg),
        "layers": {
            "ln1": _norm_spec(cfg, (n,)),
            "ln2": _norm_spec(cfg, (n,)),
            "attn": _attn_specs(cfg, (n,)),
            "mlp": _mlp_specs(cfg, (n,)),
        },
    }


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` (sorted path order) of a model
    initialized from ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1)[0])


def init_params(seed: int, cfg: ModelConfig, *, device=None) -> Params:
    """Random parameters: one generator per leaf, keyed by (seed, the leaf's
    index in sorted path order), as the reference splits one key per sorted
    leaf. Big leaves are drawn row by row (see ``init_leaf``)."""
    dev = resolve_device(device)
    flat = _flatten(param_specs(cfg))
    vals = {}
    for i, (path, spec) in enumerate(sorted(flat.items())):
        gen = torch.Generator(device=dev).manual_seed(leaf_seed(seed, i))
        vals[path] = init_leaf(gen, spec, dev)
    return _rebuild(param_specs(cfg), vals)


# ---------------------------------------------------------------------------
# Per-layer window / rope schedules (data, not control flow)
# ---------------------------------------------------------------------------

_FULL_WINDOW = 1 << 30


def layer_schedules(cfg: ModelConfig, n: int | None = None) -> tuple[list[int], list[float]]:
    """Per-layer (window, rope_base): sliding windows and dual rope bases are
    data consumed by one attention code path."""
    n = n or cfg.n_layers
    windows = [cfg.window or _FULL_WINDOW] * n
    bases = [float(cfg.rope_base)] * n
    if cfg.global_every:
        for i in range(n):
            is_global = (i + 1) % cfg.global_every == 0
            windows[i] = _FULL_WINDOW if is_global else (cfg.local_window or _FULL_WINDOW)
            bases[i] = float(cfg.global_rope_base or cfg.rope_base) if is_global \
                else float(cfg.rope_base)
    return windows, bases


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _decoder_stack(params: Params, h: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    """The dense decoder layers, one at a time from the stacked leaves."""
    windows, bases = layer_schedules(cfg)
    lp = params["layers"]
    for i in range(cfg.n_layers):
        p = {name: (leaf[i] if not isinstance(leaf, dict) else {k: v[i] for k, v in leaf.items()})
             for name, leaf in lp.items()}
        a_in = rms_norm(h, p["ln1"], cfg.norm_eps)
        h = h + attention(a_in, p["attn"], positions=positions, window=windows[i],
                          rope_base=bases[i], n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                          head_dim=cfg.hd, rotary_frac=cfg.rotary_frac)
        m_in = rms_norm(h, p["ln2"], cfg.norm_eps)
        h = h + swiglu_mlp(m_in, p["mlp"])
    return h


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   extra: dict | None = None) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D), final norm applied."""
    _check_family(cfg)
    if extra:
        raise NotImplementedError("extra inputs (audio frames) come with the audio slice")
    h = embed(tokens, params["embed"]["table"])
    positions = torch.arange(tokens.shape[1], device=h.device)
    h = _decoder_stack(params, h, cfg, positions)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def forward_loglik(params: Params, batch: dict, cfg: ModelConfig,
                   ce_chunk: int = 512) -> torch.Tensor:
    """Per-sequence log p(tokens | params): the MH local sections l_i.

    batch: tokens (B, S) int, mask (B, S) optional; next-token factorization.
    """
    tokens = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "mask")}
    h = forward_hidden(params, tokens[:, :-1], cfg, extra or None)
    targets = tokens[:, 1:]
    mask = batch.get("mask")
    mask = torch.ones_like(targets) if mask is None else mask[:, 1:]
    return unembed_loglik(h, params["embed"]["table"], targets, mask, chunk=ce_chunk)


def prefill(*args, **kw):
    raise NotImplementedError("prefill and the KV caches come with the rest of the LM stack "
                              "(LM decoding is not part of posterior serving)")


def decode_step(*args, **kw):
    raise NotImplementedError("decode_step and the KV caches come with the rest of the LM "
                              "stack (LM decoding is not part of posterior serving)")
