"""whisper-base [audio] — enc-dec, conv frontend stubbed: the caller passes
precomputed (B, 1500, D) frame embeddings as ``frames``. [arXiv:2212.04356;
unverified]"""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, enc_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048,
    vocab=51865, n_audio_frames=1500, max_seq=32768,
)
