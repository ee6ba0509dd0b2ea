"""DeepSeek-7B: llama-arch dense MHA [arXiv:2401.02954]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=102400, rope_theta=1e4,
)
