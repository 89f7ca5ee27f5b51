"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]  The 4096-token window bounds the decode KV cache (a
ring of 4096 slots), which makes the 500k-token decode shape sub-quadratic."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, window=4096, rope_base=1_000_000.0, max_seq=65536,
    sub_quadratic=True,
)
