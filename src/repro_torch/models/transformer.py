"""Config-driven decoder LM, the dense and ssm (xLSTM) families: the port
of ``repro.models.transformer``.

Parameter trees are nested dicts of tensors; :func:`param_specs` returns the
same tree with :class:`~repro_torch.models.layers.ParamSpec` leaves, so a
caller can count and size a model without allocating it. The stacked layer
axis of the reference (``lax.scan`` over layers) is kept in the tree and
walked by a Python loop.

Entry points: ``param_specs(cfg)``, ``init_params(seed, cfg, device=)``,
``forward_hidden(params, tokens, cfg)`` and ``forward_loglik(params, batch,
cfg)`` (per-sequence log-likelihoods, the local sections of the LM's MH);
for decoding ``prefill(params, tokens, cfg, max_len)`` -> (cache, last
logits) and ``decode_step(params, cache, tokens, cfg)`` -> (cache, logits),
over the caches of ``init_cache`` / ``abstract_cache`` (meta-device
tensors) / ``cache_template``. A dense cache is ``{"k", "v": (L, B, C, K,
h), "pos": (C,) int32 slot positions, -1 while empty, "len": () int32}``;
the ring holds ``effective_cache_len`` slots. An ssm cache is the stacked
recurrent states, ``{"m": (c, n, m), "s": (h, c, n, m)}``.

The other families (moe, hybrid, audio, vlm) come with later slices and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from .._device import resolve_device, tree_map
from .layers import ParamSpec, attention, embed, init_leaf, rms_norm, swiglu_mlp, unembed_loglik
from .ssm import MLSTMState, SLSTMState, mlstm_block, slstm_block

Params = dict[str, Any]

_LATER = {
    "moe": "the MoE slice",
    "hybrid": "the hybrid slice (with mamba_block)",
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
    if cfg.family not in ("dense", "ssm"):
        raise ValueError(f"unknown family {cfg.family!r}")


def _xlstm_specs(cfg: ModelConfig) -> dict:
    """Alternating mLSTM / sLSTM pairs, stacked over n_layers // 2 pairs."""
    d, pairs = cfg.d_model, cfg.n_layers // 2
    nh, dh = cfg.n_heads, d // cfg.n_heads
    return {
        "ln_m": _norm_spec(cfg, (pairs,)),
        "ln_s": _norm_spec(cfg, (pairs,)),
        "mlstm": {
            "wq": ParamSpec((pairs, d, nh, dh), ("layers", "embed", "q_heads", None)),
            "wk": ParamSpec((pairs, d, nh, dh), ("layers", "embed", "q_heads", None)),
            "wv": ParamSpec((pairs, d, nh, dh), ("layers", "embed", "q_heads", None)),
            "wi": ParamSpec((pairs, d, nh), ("layers", "embed", None)),
            "wf": ParamSpec((pairs, d, nh), ("layers", "embed", None)),
            "wo_gate": ParamSpec((pairs, d, nh), ("layers", "embed", None)),
            "out_proj": ParamSpec((pairs, d, d), ("layers", None, "embed")),
        },
        "slstm": {
            "w": ParamSpec((pairs, d, nh, 4 * dh), ("layers", "embed", "q_heads", None)),
            "r": ParamSpec((pairs, nh, dh, 4 * dh), ("layers", "q_heads", None, None)),
            "b": ParamSpec((pairs, nh, 4 * dh), ("layers", "q_heads", None), init_scale="zero"),
            "out_proj": ParamSpec((pairs, d, d), ("layers", None, "embed")),
        },
    }


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter tree with ParamSpec leaves (nothing is allocated)."""
    _check_family(cfg)
    d, v, n = cfg.d_model, cfg.vocab, cfg.n_layers
    specs = {
        "embed": {"table": ParamSpec((v, d), ("vocab", None), init_scale="embed")},
        "final_norm": _norm_spec(cfg),
    }
    if cfg.family == "ssm":
        specs["layers"] = _xlstm_specs(cfg)
    else:
        specs["layers"] = {
            "ln1": _norm_spec(cfg, (n,)),
            "ln2": _norm_spec(cfg, (n,)),
            "attn": _attn_specs(cfg, (n,)),
            "mlp": _mlp_specs(cfg, (n,)),
        }
    return specs


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


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree of stacked leaves (views, nothing copied)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _decoder_stack(params: Params, h: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, caches: dict | None = None):
    """The dense decoder layers, one at a time from the stacked leaves.
    Returns ``(h, new_cache)``; with ``caches`` every layer attends over its
    ring buffer and the new cache has this step's keys, values and slot
    positions and ``len`` advanced by S (None without)."""
    windows, bases = layer_schedules(cfg)
    lp = params["layers"]
    slot_pos = _advance_slot_pos(caches, positions) if caches is not None else None
    new_k, new_v = [], []
    for i in range(cfg.n_layers):
        p = _layer(lp, i)
        kv = None
        if caches is not None:
            kv = (caches["k"][i], caches["v"][i], caches["len"], slot_pos)
        a_in = rms_norm(h, p["ln1"], cfg.norm_eps)
        a_out, new_kv = attention(a_in, p["attn"], positions=positions, window=windows[i],
                                  rope_base=bases[i], kv_cache=kv, n_heads=cfg.n_heads,
                                  n_kv=cfg.n_kv, head_dim=cfg.hd, rotary_frac=cfg.rotary_frac)
        h = h + a_out
        m_in = rms_norm(h, p["ln2"], cfg.norm_eps)
        h = h + swiglu_mlp(m_in, p["mlp"])
        if new_kv is not None:
            new_k.append(new_kv[0])
            new_v.append(new_kv[1])
    if caches is None:
        return h, None
    return h, {"k": torch.stack(new_k), "v": torch.stack(new_v), "pos": slot_pos,
               "len": caches["len"] + positions.shape[-1]}


def _xlstm_stack(params: Params, h: torch.Tensor, cfg: ModelConfig, states: dict | None = None):
    """The xLSTM pairs: an mLSTM block, then an sLSTM block, each behind an
    RMS norm and a residual. With ``states`` (a cache) each pair continues
    from its recurrent state, and the new states come back stacked as the
    cache; without, each starts afresh and None comes back."""
    lp = params["layers"]
    m_new, s_new = [], []
    for i in range(cfg.n_layers // 2):
        p = _layer(lp, i)
        m_st = MLSTMState(*(t[i] for t in states["m"])) if states is not None else None
        s_st = SLSTMState(*(t[i] for t in states["s"])) if states is not None else None
        y, m_st = mlstm_block(rms_norm(h, p["ln_m"], cfg.norm_eps), p["mlstm"], m_st)
        h = h + y
        y, s_st = slstm_block(rms_norm(h, p["ln_s"], cfg.norm_eps), p["slstm"], s_st)
        h = h + y
        m_new.append(m_st)
        s_new.append(s_st)
    if states is None:
        return h, None
    return h, {"m": tuple(torch.stack(t) for t in zip(*m_new)),
               "s": tuple(torch.stack(t) for t in zip(*s_new))}


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   extra: dict | None = None) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D), final norm applied."""
    _check_family(cfg)
    if extra:
        raise NotImplementedError("extra inputs (audio frames) come with the audio slice")
    h = embed(tokens, params["embed"]["table"])
    if cfg.family == "ssm":
        h, _ = _xlstm_stack(params, h, cfg)
    else:
        positions = torch.arange(tokens.shape[1], device=h.device)
        h, _ = _decoder_stack(params, h, cfg, positions)
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


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def effective_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Uniform sliding-window archs keep an O(window) ring buffer even for
    very long contexts; everything else caches the full context."""
    if cfg.window:
        return min(max_len, cfg.window)
    return max_len


def cache_template(cfg: ModelConfig, batch: int, max_len: int, dtype=None) -> dict:
    """The decode cache as a tree of ParamSpecs (shapes, logical axes,
    dtypes). ``dtype`` None takes the config's ``kv_cache_dtype`` (bf16, or
    ``torch.float8_e4m3fn`` for "fp8")."""
    _check_family(cfg)
    if dtype is None:
        dtype = torch.float8_e4m3fn if cfg.kv_cache_dtype == "fp8" else torch.bfloat16
    c = effective_cache_len(cfg, max_len)
    if cfg.family == "ssm":
        pairs = cfg.n_layers // 2
        nh, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
        f32 = torch.float32
        return {
            "m": (
                ParamSpec((pairs, batch, nh, dh, dh), ("layers", "batch", "q_heads", None, None),
                          f32),
                ParamSpec((pairs, batch, nh, dh), ("layers", "batch", "q_heads", None), f32),
                ParamSpec((pairs, batch, nh), ("layers", "batch", "q_heads"), f32),
            ),
            "s": tuple(ParamSpec((pairs, batch, nh, dh), ("layers", "batch", "q_heads", None),
                                 f32) for _ in range(4)),
        }
    kv_log = ("layers", "batch", "kv_seq", "kv_heads", None)
    shape = (cfg.n_layers, batch, c, cfg.n_kv, cfg.hd)
    return {"k": ParamSpec(shape, kv_log, dtype), "v": ParamSpec(shape, kv_log, dtype),
            "pos": ParamSpec((c,), (None,), torch.int32),
            "len": ParamSpec((), (), torch.int32)}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
    """The decode cache as meta-device tensors: shapes and dtypes, no memory."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    cache_template(cfg, batch, max_len, dtype))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    """An empty decode cache: zeros, every slot position -1 (empty), and
    for the ssm family the mLSTM's max stabilizer at -1e30."""
    dev = resolve_device(device)
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                     cache_template(cfg, batch, max_len, dtype))
    if cfg.family == "ssm":
        m = list(cache["m"])
        m[2] = torch.full_like(m[2], -1e30)
        cache["m"] = tuple(m)
    else:
        cache["pos"] = torch.full_like(cache["pos"], -1)
    return cache


def _advance_slot_pos(cache: dict, positions: torch.Tensor) -> torch.Tensor:
    """The ring buffer's slot -> absolute position map, advanced once a step
    (on the device: the insert slot is ``len % C``, clamped so S fit)."""
    slot_pos, length = cache["pos"], cache["len"]
    c, s = slot_pos.shape[0], positions.shape[-1]
    if s >= c:  # (re)filling the whole ring: the tail at slots p % C
        shift = (s - c) % c
        return torch.roll(positions[-c:].to(torch.int32), shift)
    start = torch.clamp(length % c, max=c - s)
    return slot_pos.index_copy(0, start + torch.arange(s, device=slot_pos.device),
                               positions.to(torch.int32))


def decode_step(params: Params, cache: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """One decoding step: tokens (B, 1) -> (new_cache, logits (B, V) float32)."""
    _check_family(cfg)
    h = embed(tokens, params["embed"]["table"])
    if cfg.family == "ssm":
        h, cache = _xlstm_stack(params, h, cfg, states=cache)
    else:
        positions = cache["len"] + torch.arange(tokens.shape[1], device=h.device)
        h, cache = _decoder_stack(params, h, cfg, positions, caches=cache)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", h, params["embed"]["table"])
    return cache, logits[:, -1].to(torch.float32)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            extra: dict | None = None):
    """Process a whole prompt (B, S) into a fresh cache of ``max_len``
    positions; returns ``(cache, logits of the last position (B, V) float32)``."""
    _check_family(cfg)
    if extra:
        raise NotImplementedError("extra inputs (audio frames) come with the audio slice")
    b, s = tokens.shape
    h = embed(tokens, params["embed"]["table"])
    cache = init_cache(cfg, b, max_len, device=h.device)
    if cfg.family == "ssm":
        h, cache = _xlstm_stack(params, h, cfg, states=cache)
    else:
        h, cache = _decoder_stack(params, h, cfg, torch.arange(s, device=h.device), caches=cache)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bd,vd->bv", h[:, -1], params["embed"]["table"])
    return cache, logits.to(torch.float32)
