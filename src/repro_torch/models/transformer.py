"""Config-driven LM stack, every family of the reference: dense, moe, ssm
(xLSTM), hybrid (Jamba), audio (Whisper's encoder-decoder) and vlm (an
early-fusion decoder with qk-norm). The port of ``repro.models.transformer``.

Parameter trees are nested dicts of tensors; :func:`param_specs` returns the
same tree with :class:`~repro_torch.models.layers.ParamSpec` leaves, and
:func:`abstract_params` the tree as meta-device tensors, so a caller can
count and size a model without allocating it. The stacked layer axis of the
reference (``lax.scan`` over layers) is kept in the tree and walked by a
Python loop. A leaf may be sharded over a mesh of slots
(:class:`repro_torch.distributed.ShardedTensor`): the stack then gathers one
layer's rows at a time, and each top-level leaf just before it is read, on
the leaf's home device, where all compute runs.

Entry points: ``param_specs(cfg)``, ``abstract_params(cfg)``,
``init_params(seed, cfg, device=)``, ``forward_hidden(params, tokens, cfg,
extra)`` and ``forward_loglik(params, batch, cfg)`` (per-sequence
log-likelihoods, the local sections of the LM's MH; the audio family reads
``batch["frames"]``, (B, T_audio, D) frame embeddings); for decoding
``prefill(params, tokens, cfg, max_len, extra)`` -> (cache, last logits) and
``decode_step(params, cache, tokens, cfg)`` -> (cache, logits), over the
caches of ``init_cache`` / ``abstract_cache`` (meta-device tensors) /
``cache_template``. A dense, moe or vlm cache is ``{"k", "v": (L, B, C, K,
h), "pos": (C,) int32 slot positions, -1 while empty, "len": () int32}``;
the ring holds ``effective_cache_len`` slots. A hybrid cache adds the
stacked Mamba states ``"conv"`` (P, L_m, B, kernel - 1, di) and ``"ssm"``
(P, L_m, B, di, ds) float32, with k/v one attention layer a period; an audio
cache adds ``"enc_out"`` (B, T_audio, D), the encoder's output, which every
decode step's cross-attention reads. An ssm cache is the stacked recurrent
states, ``{"m": (c, n, m), "s": (h, c, n, m)}``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from .._device import resolve_device, tree_map
from ..distributed.sharding import whole
from .layers import (ParamSpec, attention, embed, gelu_mlp, init_leaf, moe_mlp, rms_norm,
                     swiglu_mlp, unembed_loglik)
from .ssm import MambaState, MLSTMState, SLSTMState, mamba_block, mlstm_block, slstm_block

Params = dict[str, Any]
F32 = torch.float32
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


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

    def active_param_count(self) -> int:
        """MoE-aware: a leaf on the experts axis counts at top_k / n_experts."""
        total = 0
        for s in _flatten(param_specs(self)).values():
            n = s.numel
            if "experts" in s.logical and self.n_experts > 0:
                n = int(n * self.top_k / self.n_experts)
            total += n
        return total


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


def _moe_specs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    sl = ("layers",) * len(stack)
    return {
        "router": ParamSpec(stack + (d, e), sl + ("embed", None)),
        "wi_gate": ParamSpec(stack + (e, d, f), sl + ("experts", "embed", "expert_mlp")),
        "wi_up": ParamSpec(stack + (e, d, f), sl + ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec(stack + (e, f, d), sl + ("experts", "expert_mlp", "embed")),
    }


def _mamba_specs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.mamba_d_state
    dtr, k = cfg.dt_rank_eff, cfg.mamba_d_conv
    sl = ("layers",) * len(stack)
    m = "mamba_inner"
    return {
        "in_proj": ParamSpec(stack + (d, 2 * di), sl + ("embed", m)),
        "conv_w": ParamSpec(stack + (k, di), sl + ("conv", m), init_scale="normal"),
        "conv_b": ParamSpec(stack + (di,), sl + (m,), init_scale="zero"),
        "x_proj": ParamSpec(stack + (di, dtr + 2 * ds), sl + (m, None)),
        "dt_proj": ParamSpec(stack + (dtr, di), sl + (None, m)),
        "dt_bias": ParamSpec(stack + (di,), sl + (m,), init_scale="zero"),
        "a_log": ParamSpec(stack + (di, ds), sl + (m, "state"), init_scale="zero"),
        "d_skip": ParamSpec(stack + (di,), sl + (m,), init_scale="one"),
        "out_proj": ParamSpec(stack + (di, d), sl + (m, "embed")),
    }


def _gelu_mlp_specs(cfg: ModelConfig, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamSpec((n, d, f), ("layers", "embed", "mlp")),
        "bi": ParamSpec((n, f), ("layers", "mlp"), init_scale="zero"),
        "wo": ParamSpec((n, f, d), ("layers", "mlp", "embed")),
        "bo": ParamSpec((n, d), ("layers", "embed"), init_scale="zero"),
    }


def _norm_spec(cfg: ModelConfig, stack: tuple = ()) -> ParamSpec:
    return ParamSpec(stack + (cfg.d_model,), ("layers",) * len(stack) + (None,),
                     init_scale="zero")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
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
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        specs["layers"] = {
            "ln1": _norm_spec(cfg, (n,)),
            "ln2": _norm_spec(cfg, (n,)),
            "attn": _attn_specs(cfg, (n,)),
            **({"moe": _moe_specs(cfg, (n,))} if fam == "moe" else {"mlp": _mlp_specs(cfg, (n,))}),
        }
    elif fam == "ssm":
        specs["layers"] = _xlstm_specs(cfg)
    elif fam == "hybrid":  # Jamba: periods of attn_period layers, one of them attention
        p, ap = n // cfg.attn_period, cfg.attn_period
        n_moe = ap // cfg.moe_every
        specs["layers"] = {
            "ln_mix": _norm_spec(cfg, (p, ap)),
            "ln_mlp": _norm_spec(cfg, (p, ap)),
            "attn": _attn_specs(cfg, (p,)),
            "mamba": _mamba_specs(cfg, (p, ap - 1)),
            "moe": _moe_specs(cfg, (p, n_moe)),
            "mlp": _mlp_specs(cfg, (p, ap - n_moe)),
        }
    else:  # audio, Whisper: an encoder, and a decoder with cross-attention
        ne = cfg.enc_layers
        specs["enc"] = {
            "pos": ParamSpec((cfg.n_audio_frames, d), (None, "embed"), init_scale="normal"),
            "layers": {
                "ln1": _norm_spec(cfg, (ne,)),
                "ln2": _norm_spec(cfg, (ne,)),
                "attn": _attn_specs(cfg, (ne,)),
                "mlp": _gelu_mlp_specs(cfg, ne),
            },
            "final_norm": _norm_spec(cfg),
        }
        specs["dec_pos"] = ParamSpec((cfg.max_seq, d), (None, "embed"), init_scale="normal")
        specs["layers"] = {
            "ln1": _norm_spec(cfg, (n,)),
            "ln_x": _norm_spec(cfg, (n,)),
            "ln2": _norm_spec(cfg, (n,)),
            "attn": _attn_specs(cfg, (n,)),
            "xattn": _attn_specs(cfg, (n,)),
            "mlp": _gelu_mlp_specs(cfg, n),
        }
    return specs


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta-device tensors: shapes and dtypes, no memory."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    param_specs(cfg))


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
    """Layer ``i`` of a tree of stacked leaves: views, nothing copied; of a
    sharded leaf, row ``i`` gathered on its home device (dropped with the
    layer's tree)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _attn_kwargs(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd, rotary_frac=cfg.rotary_frac)


def _new_cache(caches: dict, positions: torch.Tensor, slot_pos: torch.Tensor, **leaves) -> dict:
    """A cache after a step: its stacked leaves, the advanced slot positions
    and ``len`` advanced by S."""
    return {**leaves, "pos": slot_pos, "len": caches["len"] + positions.shape[-1]}


def _decoder_stack(params: Params, h: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, caches: dict | None = None):
    """The dense, moe and vlm decoder layers, one at a time from the stacked
    leaves (the vlm's qk-norm lives in its attention's leaves; the moe family
    takes ``moe_mlp`` for the MLP). Returns ``(h, new_cache)``; with
    ``caches`` every layer attends over its ring buffer and the new cache
    has this step's keys, values and slot positions and ``len`` advanced by
    S (None without)."""
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
                                  rope_base=bases[i], kv_cache=kv, **_attn_kwargs(cfg))
        h = h + a_out
        m_in = rms_norm(h, p["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            h = h + moe_mlp(m_in, p["moe"], top_k=cfg.top_k)
        else:
            h = h + swiglu_mlp(m_in, p["mlp"])
        if new_kv is not None:
            new_k.append(new_kv[0])
            new_v.append(new_kv[1])
    if caches is None:
        return h, None
    return h, _new_cache(caches, positions, slot_pos, k=torch.stack(new_k), v=torch.stack(new_v))


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


def _jamba_stack(params: Params, h: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                 caches: dict | None = None):
    """Jamba's periods of ``attn_period`` layers: attention at
    ``attn_index``, Mamba at the others; ``moe_mlp`` at every ``moe_every``-th
    layer, the SwiGLU MLP at the rest. With ``caches`` the attention layer
    runs on its period's ring and each Mamba layer continues from its
    state; the new cache holds the stacked k/v (P, ...) and the Mamba states
    (P, L_m, ...), conv in the activations' dtype and ssm in float32."""
    lp = params["layers"]
    ap = cfg.attn_period
    window = cfg.window or _FULL_WINDOW
    slot_pos = _advance_slot_pos(caches, positions) if caches is not None else None
    ks, vs, convs, ssms = [], [], [], []
    for pi in range(cfg.n_layers // ap):
        p = _layer(lp, pi)
        m_i = moe_i = mlp_i = 0
        states = []
        for li in range(ap):
            mix_in = rms_norm(h, p["ln_mix"][li], cfg.norm_eps)
            if li == cfg.attn_index:
                kv = None
                if caches is not None:
                    kv = (caches["k"][pi], caches["v"][pi], caches["len"], slot_pos)
                y, new_kv = attention(mix_in, p["attn"], positions=positions, window=window,
                                      rope_base=cfg.rope_base, kv_cache=kv, **_attn_kwargs(cfg))
                if new_kv is not None:
                    ks.append(new_kv[0])
                    vs.append(new_kv[1])
            else:
                st = None
                if caches is not None:
                    st = MambaState(caches["conv"][pi][m_i], caches["ssm"][pi][m_i])
                y, st = mamba_block(mix_in, _layer(p["mamba"], m_i), st)
                states.append(st)
                m_i += 1
            h = h + y
            mlp_in = rms_norm(h, p["ln_mlp"][li], cfg.norm_eps)
            if li % cfg.moe_every == 0:
                y = moe_mlp(mlp_in, _layer(p["moe"], moe_i), top_k=cfg.top_k)
                moe_i += 1
            else:
                y = swiglu_mlp(mlp_in, _layer(p["mlp"], mlp_i))
                mlp_i += 1
            h = h + y
        if caches is not None:
            convs.append(torch.stack([st.conv for st in states]))
            ssms.append(torch.stack([st.ssm for st in states]))
    if caches is None:
        return h, None
    return h, _new_cache(caches, positions, slot_pos, k=torch.stack(ks), v=torch.stack(vs),
                         conv=torch.stack(convs), ssm=torch.stack(ssms))


def _whisper_encode(params: Params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, T_audio, D) precomputed frame embeddings (the conv front
    end is stubbed, as in the reference). Non-causal attention without rope,
    learned positions, the GELU MLP; the encoder's final norm applied."""
    ep = params["enc"]
    h = frames + whole(ep["pos"])[None, :frames.shape[1]].to(frames.dtype)
    pos = torch.arange(frames.shape[1], device=frames.device)
    for i in range(cfg.enc_layers):
        p = _layer(ep["layers"], i)
        a, _ = attention(rms_norm(h, p["ln1"], cfg.norm_eps), p["attn"], positions=pos,
                         window=_FULL_WINDOW, rope_base=cfg.rope_base, causal=False,
                         use_rope=False, **_attn_kwargs(cfg))
        h = h + a
        h = h + gelu_mlp(rms_norm(h, p["ln2"], cfg.norm_eps), p["mlp"])
    return rms_norm(h, whole(ep["final_norm"]), cfg.norm_eps)


def _cross_attention(x: torch.Tensor, enc_out: torch.Tensor, p: Params,
                     cfg: ModelConfig) -> torch.Tensor:
    """The decoder's queries over the encoder's output (no mask, no rope);
    the keys and values are computed from ``enc_out`` at every call."""
    b, s, _ = x.shape
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("btd,dkh->btkh", enc_out, p["wk"])
    v = torch.einsum("btd,dkh->btkh", enc_out, p["wv"])
    qg = q.reshape(b, s, cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).to(F32) * cfg.hd ** -0.5
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v).reshape(b, s, cfg.n_heads, cfg.hd)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"])


def _whisper_decode_stack(params: Params, h: torch.Tensor, enc_out: torch.Tensor,
                          cfg: ModelConfig, positions: torch.Tensor, caches: dict | None = None):
    """Whisper's decoder: learned positions (taken at ``min(position,
    max_seq - 1)``), causal self-attention without rope over the ring,
    cross-attention over ``enc_out``, the GELU MLP."""
    lp = params["layers"]
    pos_emb = whole(params["dec_pos"])[torch.clamp(positions, max=cfg.max_seq - 1)]
    h = h + pos_emb[None].to(h.dtype)
    slot_pos = _advance_slot_pos(caches, positions) if caches is not None else None
    new_k, new_v = [], []
    for i in range(cfg.n_layers):
        p = _layer(lp, i)
        kv = None
        if caches is not None:
            kv = (caches["k"][i], caches["v"][i], caches["len"], slot_pos)
        a, new_kv = attention(rms_norm(h, p["ln1"], cfg.norm_eps), p["attn"],
                              positions=positions, window=_FULL_WINDOW, rope_base=cfg.rope_base,
                              kv_cache=kv, use_rope=False, **_attn_kwargs(cfg))
        h = h + a
        h = h + _cross_attention(rms_norm(h, p["ln_x"], cfg.norm_eps), enc_out, p["xattn"], cfg)
        h = h + gelu_mlp(rms_norm(h, p["ln2"], cfg.norm_eps), p["mlp"])
        if new_kv is not None:
            new_k.append(new_kv[0])
            new_v.append(new_kv[1])
    if caches is None:
        return h, None
    return h, _new_cache(caches, positions, slot_pos, k=torch.stack(new_k), v=torch.stack(new_v))


def _frames(cfg: ModelConfig, extra: dict | None) -> torch.Tensor:
    """The audio family's frame embeddings, which it cannot run without."""
    if not extra or extra.get("frames") is None:
        raise ValueError(f"{cfg.name}: the audio family needs frame embeddings, "
                         "extra['frames'] / batch['frames'] of shape (B, T_audio, D); "
                         "none were given")
    return extra["frames"]


def _stack(params: Params, h: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
           caches: dict | None, enc_out: torch.Tensor | None = None):
    """The family's layers over embedded tokens ``h``: ``(h, new_cache)``."""
    fam = cfg.family
    if fam == "ssm":
        return _xlstm_stack(params, h, cfg, states=caches)
    if fam == "hybrid":
        return _jamba_stack(params, h, cfg, positions, caches=caches)
    if fam == "audio":
        sub = None if caches is None else {k: caches[k] for k in ("k", "v", "pos", "len")}
        h, sub = _whisper_decode_stack(params, h, enc_out, cfg, positions, caches=sub)
        return h, None if caches is None else {**caches, **sub}
    return _decoder_stack(params, h, cfg, positions, caches=caches)


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   extra: dict | None = None) -> torch.Tensor:
    """Token ids (B, S) -> final hidden states (B, S, D), final norm applied.
    The audio family encodes ``extra["frames"]`` first (ValueError without)."""
    _check_family(cfg)
    h = embed(tokens, whole(params["embed"]["table"]))
    positions = torch.arange(tokens.shape[1], device=h.device)
    enc_out = _whisper_encode(params, _frames(cfg, extra), cfg) if cfg.family == "audio" else None
    h, _ = _stack(params, h, cfg, positions, None, enc_out)
    return rms_norm(h, whole(params["final_norm"]), cfg.norm_eps)


def forward_loglik(params: Params, batch: dict, cfg: ModelConfig,
                   ce_chunk: int = 512) -> torch.Tensor:
    """Per-sequence log p(tokens | params): the MH local sections l_i.

    batch: tokens (B, S) int, mask (B, S) optional; next-token factorization;
    the audio family adds frames (B, T_audio, D).
    """
    tokens = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "mask")}
    h = forward_hidden(params, tokens[:, :-1], cfg, extra or None)
    targets = tokens[:, 1:]
    mask = batch.get("mask")
    mask = torch.ones_like(targets) if mask is None else mask[:, 1:]
    return unembed_loglik(h, whole(params["embed"]["table"]), targets, mask, chunk=ce_chunk)


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
    fam = cfg.family
    if fam == "ssm":
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

    def kv(n):
        shape = (n, batch, c, cfg.n_kv, cfg.hd)
        return {"k": ParamSpec(shape, kv_log, dtype), "v": ParamSpec(shape, kv_log, dtype)}

    ring = {"pos": ParamSpec((c,), (None,), torch.int32), "len": ParamSpec((), (), torch.int32)}
    if fam == "hybrid":
        p, n_m = cfg.n_layers // cfg.attn_period, cfg.attn_period - 1
        return {
            **kv(p),
            "conv": ParamSpec((p, n_m, batch, cfg.mamba_d_conv - 1, cfg.d_inner),
                              ("layers", None, "batch", None, "mlp"), dtype),
            "ssm": ParamSpec((p, n_m, batch, cfg.d_inner, cfg.mamba_d_state),
                             ("layers", None, "batch", "mlp", None), torch.float32),
            **ring,
        }
    if fam == "audio":
        return {**kv(cfg.n_layers), **ring,
                "enc_out": ParamSpec((batch, cfg.n_audio_frames, cfg.d_model),
                                     ("batch", None, "embed_tp"), dtype)}
    return {**kv(cfg.n_layers), **ring}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
    """The decode cache as meta-device tensors: shapes and dtypes, no memory."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    cache_template(cfg, batch, max_len, dtype))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               enc_out: torch.Tensor | None = None, device=None) -> dict:
    """An empty decode cache: zeros, every slot position -1 (empty), for the
    ssm family the mLSTM's max stabilizer at -1e30; ``enc_out`` (the audio
    family's encoder output) is kept as given."""
    dev = resolve_device(device)
    tmpl = cache_template(cfg, batch, max_len, dtype)
    if enc_out is not None:
        tmpl.pop("enc_out", None)
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev), tmpl)
    if cfg.family == "ssm":
        m = list(cache["m"])
        m[2] = torch.full_like(m[2], -1e30)
        cache["m"] = tuple(m)
    else:
        cache["pos"] = torch.full_like(cache["pos"], -1)
    if enc_out is not None:
        cache["enc_out"] = enc_out
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
    """One decoding step: tokens (B, 1) -> (new_cache, logits (B, V) float32).
    The audio family's cross-attention reads the cache's ``enc_out``."""
    _check_family(cfg)
    h = embed(tokens, whole(params["embed"]["table"]))
    positions = None
    if cfg.family != "ssm":
        positions = cache["len"] + torch.arange(tokens.shape[1], device=h.device)
    h, cache = _stack(params, h, cfg, positions, cache, cache.get("enc_out"))
    h = rms_norm(h, whole(params["final_norm"]), cfg.norm_eps)
    logits = torch.einsum("bsd,vd->bsv", h, whole(params["embed"]["table"]))
    return cache, logits[:, -1].to(torch.float32)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            extra: dict | None = None):
    """Process a whole prompt (B, S) into a fresh cache of ``max_len``
    positions; returns ``(cache, logits of the last position (B, V) float32)``.
    The audio family encodes ``extra["frames"]`` once and keeps the output in
    the cache as ``enc_out``."""
    _check_family(cfg)
    b, s = tokens.shape
    h = embed(tokens, whole(params["embed"]["table"]))
    enc_out = _whisper_encode(params, _frames(cfg, extra), cfg) if cfg.family == "audio" else None
    cache = init_cache(cfg, b, max_len, enc_out=enc_out, device=h.device)
    h, cache = _stack(params, h, cfg, torch.arange(s, device=h.device), cache, enc_out)
    h = rms_norm(h, whole(params["final_norm"]), cfg.norm_eps)
    logits = torch.einsum("bd,vd->bv", h[:, -1], whole(params["embed"]["table"]))
    return cache, logits.to(torch.float32)
