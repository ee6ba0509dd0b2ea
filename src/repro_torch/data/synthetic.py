"""Deterministic synthetic batches for every model family.

The reference's numpy draws from the same seed, in the same order,
returned as tensors on an explicit device, so the port and the reference
see the same tokens, patch embeddings and frames bit for bit.
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

    A vision config adds ``vision_embeds`` (B, frontend_len,
    frontend_dim) and masks the loss over those positions; an
    encoder-decoder adds ``enc_frames`` (B, seq, frontend_dim).  Both are
    float32 standard normals drawn after the tokens, the patches first.
    """
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
    mask = np.ones((batch, seq), np.float32)
    out = {
        "tokens": torch.from_numpy(tokens).to(device),
        "labels": torch.from_numpy(np.roll(tokens, -1, axis=1)).to(device),
    }
    if cfg.frontend == "vision":
        out["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.frontend_len, cfg.frontend_dim)).astype(
                np.float32)).to(device)
        # vision positions carry no next-token signal
        mask[:, :cfg.frontend_len] = 0.0
    if cfg.enc_dec:
        out["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (batch, seq, cfg.frontend_dim)).astype(np.float32)).to(device)
    out["loss_mask"] = torch.from_numpy(mask).to(device)
    return out
