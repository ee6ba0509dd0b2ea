"""Deterministic synthetic batches for the dense LM family.

The reference's numpy draws from the same seed, returned as tensors on
an explicit device, so the port and the reference see the same tokens.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.config import ModelConfig

__all__ = ["make_batch"]


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Tokens, next-token labels and a loss mask, on ``device``.

    The vision and encoder-decoder extras (patch and frame embeddings)
    wait with their families.
    """
    if cfg.frontend or cfg.enc_dec:
        from ..models.lm import check_family
        check_family(cfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
    return {
        "tokens": torch.from_numpy(tokens).to(device),
        "labels": torch.from_numpy(np.roll(tokens, -1, axis=1)).to(device),
        "loss_mask": torch.ones((batch, seq), dtype=torch.float32,
                                device=device),
    }
