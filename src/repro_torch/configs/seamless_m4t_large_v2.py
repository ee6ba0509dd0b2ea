"""SeamlessM4T-large-v2 backbone: 24L encoder + 24L decoder, audio
frontend stubbed to frame embeddings [arXiv:2308.11596]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, rope_theta=1e4,
    enc_dec=True, n_enc_layers=24,
    frontend="audio", frontend_dim=160,
)
