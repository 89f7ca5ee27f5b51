"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=65536,
    n_experts=16, top_k=2, moe_every=2, attn_period=8, attn_index=4,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    rope_base=10_000.0, max_seq=262144, sub_quadratic=True,
)
