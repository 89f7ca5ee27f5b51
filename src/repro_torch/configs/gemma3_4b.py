"""gemma3-4b [dense] — 5:1 local:global attention, 128k context, GQA kv=4.
[hf:google/gemma-3-1b-pt; unverified]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv=4, d_ff=10240, vocab=262144,
    head_dim=256, qk_norm=True,
    local_window=1024, global_every=6, rope_base=10_000.0,
    global_rope_base=1_000_000.0, max_seq=131072,
)
