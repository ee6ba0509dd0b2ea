"""Oracle for STREAM Triad: a = b + q * c."""
from __future__ import annotations

import torch


def triad_ref(b: torch.Tensor, c: torch.Tensor, q) -> torch.Tensor:
    """a_i = b_i + q * c_i, with q held in b's dtype."""
    qt = torch.tensor(q, dtype=b.dtype, device=b.device)
    return (b + qt * c).to(b.dtype)
