"""internlm2-20b [dense] — GQA kv=8. [arXiv:2403.17297; hf]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=92544,
    rope_base=1_000_000.0, max_seq=32768,
)
