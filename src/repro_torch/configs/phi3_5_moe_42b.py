"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400, vocab=32064,
    n_experts=16, top_k=2, rope_base=10_000.0, max_seq=131072,
)
