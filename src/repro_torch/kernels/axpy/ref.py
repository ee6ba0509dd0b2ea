"""Oracle for AXPY: y = a*x + y."""
from __future__ import annotations

import torch


def axpy_ref(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """out_i = a * x_i + y_i, with a held in x's dtype."""
    at = torch.tensor(a, dtype=x.dtype, device=x.device)
    return (at * x + y).to(x.dtype)
