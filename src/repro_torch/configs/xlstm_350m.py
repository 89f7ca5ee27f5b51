"""xlstm-350m [ssm]: alternating mLSTM and sLSTM blocks, d_ff=0 (the blocks
carry their own projections). [arXiv:2405.04517; unverified]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    max_seq=1 << 20, sub_quadratic=True,
)
