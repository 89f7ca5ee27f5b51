"""chatglm3-6b [dense] — 2d (partial) RoPE, GQA kv=2. [arXiv:2406.12793; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv=2, d_ff=13696, vocab=65024,
    rotary_frac=0.5, rope_base=10_000.0, max_seq=32768,
)
