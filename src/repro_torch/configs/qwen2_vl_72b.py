"""Qwen2-VL-72B backbone: M-RoPE, GQA kv=8; vision frontend is a stub
(input_specs supplies patch embeddings) [arXiv:2409.12191]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, qkv_bias=True,
    rope_kind="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="vision", frontend_dim=1280, frontend_len=1024,
)
