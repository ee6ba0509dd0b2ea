"""Architecture registry: ``--arch <id>`` resolves here.

Every assigned architecture (10) plus the paper's own kernel workloads.
``reduced(cfg)`` shrinks any config to a CPU-smoke-test size of the same
family (small depth/width, few experts, tiny vocab).  Plain data, copied
from the reference package so that the port imports none of it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.config import ModelConfig
from . import (deepseek_7b, deepseek_v2_lite_16b, mamba2_780m,
               mistral_nemo_12b, qwen15_32b, qwen2_vl_72b, qwen3_moe_235b,
               seamless_m4t_large_v2, stablelm_12b, zamba2_7b)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (zamba2_7b, qwen2_vl_72b, stablelm_12b, mistral_nemo_12b,
              deepseek_7b, qwen15_32b, qwen3_moe_235b, deepseek_v2_lite_16b,
              mamba2_780m, seamless_m4t_large_v2)
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving smoke-test config (runs a step on 1 CPU core)."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
    )
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=64,
                  first_dense_layers=min(cfg.first_dense_layers, 1),
                  dense_d_ff=256 if cfg.first_dense_layers else 0)
    if cfg.use_mla:
        kw.update(kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                  v_head_dim=32, head_dim=None)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=32, ssm_chunk=32)
    if cfg.family == "hybrid":
        kw.update(n_layers=7, attn_every=3)  # 2 supers + 1 tail layer
    if cfg.enc_dec:
        kw.update(n_enc_layers=2)
    if cfg.frontend == "vision":
        kw.update(frontend_dim=64, frontend_len=8)
    if cfg.frontend == "audio":
        kw.update(frontend_dim=40)
    if cfg.rope_kind == "mrope":
        kw.update(mrope_sections=(4, 6, 6), head_dim=32)
    return dataclasses.replace(cfg, **kw)
