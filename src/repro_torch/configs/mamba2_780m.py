"""Mamba2-780m: attention-free SSD [arXiv:2405.21060]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280, rope_kind="none",
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=128,
    sub_quadratic=True,
)
