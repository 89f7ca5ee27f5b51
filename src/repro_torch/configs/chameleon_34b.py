"""chameleon-34b [vlm] — early-fusion mixed-modal token stream; VQ image
tokens live in the shared vocab; modality frontend stubbed (tokens arrive
pre-quantized). qk-norm as in the paper. [arXiv:2405.09818; unverified]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv=8, d_ff=22016, vocab=65536,
    qk_norm=True, rope_base=10_000.0, max_seq=32768,
)
