"""Architecture registry of the port: the ten configurations, the input
shape sets and the reduced smoke variants (the port of ``repro.configs``).

``ARCHS`` holds the reference's ten architectures in its order, the same
dataclass values: four dense, two moe, the ssm xlstm-350m, the hybrid
jamba-v0.1-52b, the audio whisper-base and the vlm chameleon-34b.
"""
from __future__ import annotations

import dataclasses

from ..models.transformer import ModelConfig
from . import (
    chameleon_34b,
    chatglm3_6b,
    gemma3_4b,
    internlm2_20b,
    jamba_v0_1_52b,
    mixtral_8x22b,
    phi3_5_moe_42b,
    qwen1_5_32b,
    whisper_base,
    xlstm_350m,
)

ARCHS: dict[str, ModelConfig] = {
    "qwen1.5-32b": qwen1_5_32b.CONFIG,
    "gemma3-4b": gemma3_4b.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "chatglm3-6b": chatglm3_6b.CONFIG,
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b.CONFIG,
    "xlstm-350m": xlstm_350m.CONFIG,
    "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
    "whisper-base": whisper_base.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason). long_500k needs sub-quadratic decoding; every
    architecture here has a decoder. The reason is the reference's string."""
    cfg = ARCHS[arch]
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full attention: a 524288-token KV cache at full attention is "
            "the quadratic regime this shape excludes (skip noted in DESIGN.md)"
        )
    return True, ""


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests: the structure (window
    pattern, MoE cadence, hybrid period, enc-dec) at toy width; the
    reference's rule, field for field."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        d_model=64,
        n_heads=4,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab=128,
        head_dim=16 if cfg.head_dim else None,
        max_seq=256,
    )
    if cfg.family in ("dense", "vlm"):
        kw["n_layers"] = 6 if cfg.global_every else 3
    elif cfg.family == "moe":
        kw["n_layers"] = 2
        kw["n_experts"] = 4
        kw["top_k"] = min(cfg.top_k, 2)
    elif cfg.family == "ssm":
        kw["n_layers"] = 4
    elif cfg.family == "hybrid":
        kw["n_layers"] = cfg.attn_period
        kw["n_experts"] = 4
        kw["top_k"] = 2
    elif cfg.family == "audio":
        kw["n_layers"] = 2
        kw["enc_layers"] = 2
        kw["n_audio_frames"] = 16
    if cfg.window:
        kw["window"] = 32
    if cfg.local_window:
        kw["local_window"] = 16
    if cfg.mamba_expand:
        kw["mamba_d_state"] = 8
        kw["dt_rank"] = 8
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "reduce_config", "shape_applicable"]
