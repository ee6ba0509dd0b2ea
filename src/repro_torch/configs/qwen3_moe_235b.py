"""Qwen3-235B-A22B: 128-expert top-8 MoE, GQA kv=4 [hf:Qwen/Qwen3-235B-A22B]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, rope_theta=1e6,
    n_experts=128, top_k=8, moe_d_ff=1536, capacity_factor=1.25,
)
