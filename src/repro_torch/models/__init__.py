"""The LM stack, dense family (the port of ``repro.models``)."""
from .transformer import (
    ModelConfig,
    decode_step,
    forward_hidden,
    forward_loglik,
    init_params,
    layer_schedules,
    param_specs,
    prefill,
)

__all__ = [
    "ModelConfig",
    "decode_step",
    "forward_hidden",
    "forward_loglik",
    "init_params",
    "layer_schedules",
    "param_specs",
    "prefill",
]
