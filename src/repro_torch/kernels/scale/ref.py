"""Oracle for STREAM SCALE (paper §3.1): a = q * b."""
from __future__ import annotations

import torch


def scale_ref(b: torch.Tensor, q) -> torch.Tensor:
    """a_i = q * b_i, with q held in b's dtype."""
    return (torch.tensor(q, dtype=b.dtype, device=b.device) * b).to(b.dtype)
