"""The LM stack, every family: dense, moe, ssm (xLSTM), hybrid (Jamba),
audio (Whisper) and vlm (the port of ``repro.models``)."""
from .transformer import (
    ModelConfig,
    abstract_cache,
    abstract_params,
    cache_template,
    decode_step,
    effective_cache_len,
    forward_hidden,
    forward_loglik,
    init_cache,
    init_params,
    layer_schedules,
    param_specs,
    prefill,
)

__all__ = [
    "ModelConfig",
    "abstract_cache",
    "abstract_params",
    "cache_template",
    "decode_step",
    "effective_cache_len",
    "forward_hidden",
    "forward_loglik",
    "init_cache",
    "init_params",
    "layer_schedules",
    "param_specs",
    "prefill",
]
