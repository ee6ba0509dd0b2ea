"""DeepSeek-V2-Lite: MLA (kv_lora=512) + 64 routed / 2 shared experts
top-6, first layer dense (DESIGN.md records the 160-routed discrepancy in
the assignment brief) [arXiv:2405.04434]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, rope_theta=1e4,
    use_mla=True, kv_lora_rank=512, q_lora_rank=0,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    first_dense_layers=1, dense_d_ff=10944,
)
