"""Zamba2-7B: Mamba2 backbone + one shared attention block every 6 SSM
layers (parameter sharing preserved) [arXiv:2411.15242]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=128,
    attn_every=6, rope_theta=1e4,
    sub_quadratic=True,
)
