"""Stencil oracle: zero boundary, t fused timesteps."""
from __future__ import annotations

import torch

from .defs import StencilSpec


def shift_zero(u: torch.Tensor, off) -> torch.Tensor:
    """u shifted so out[p] = u[p + off], zeros outside the domain."""
    out = torch.zeros_like(u)
    dst, src = [], []
    for d, size in zip(off, u.shape):
        if abs(d) >= size:
            return out
        dst.append(slice(max(0, -d), size - max(0, d)))
        src.append(slice(max(0, d), size - max(0, -d)))
    out[tuple(dst)] = u[tuple(src)]
    return out


def stencil_ref(u: torch.Tensor, spec: StencilSpec, steps: int = 1
                ) -> torch.Tensor:
    """Apply the stencil `steps` times with zero boundary conditions."""
    if u.ndim != spec.ndim:
        raise ValueError(f"{spec.ndim}-D stencil on a {u.ndim}-D array")
    for _ in range(steps):
        acc = torch.zeros_like(u)
        for off, w in zip(spec.offsets, spec.weights):
            acc = acc + torch.tensor(w, dtype=u.dtype) * shift_zero(u, off)
        u = acc
    return u

