"""qwen1.5-32b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392, vocab=152064,
    qkv_bias=True, rope_base=1_000_000.0, max_seq=32768,
)
