"""AXPY entry points, one per engine.

AXPY (``y = a*x + y``) sits at the same roofline position as Triad
(I = 2/(3D)).  Matrix engine: ``Y' = X (aI) + Y I`` -- the identity
trick again, one tensor-core product per term.  Per the paper's Eq. 23
ceiling this cannot help, which is the point.  Both launch
``csrc/elementwise.cu``.
"""
from __future__ import annotations

import torch

from ...core.dispatch import elementwise_call


def axpy_vector(a, x: torch.Tensor, y: torch.Tensor, *,
                backend: str = "cuda", block_rows: int = None,
                lanes: int = None) -> torch.Tensor:
    """y' = a * x + y on the CUDA cores."""
    return elementwise_call("axpy", x, a, y, engine="vector",
                            backend=backend, block_rows=block_rows,
                            lanes=lanes)


def axpy_matrix(a, x: torch.Tensor, y: torch.Tensor, *,
                backend: str = "cuda", block_rows: int = None,
                lanes: int = None) -> torch.Tensor:
    """y' = X (aI) + Y I on the tensor cores."""
    return elementwise_call("axpy", x, a, y, engine="matrix",
                            backend=backend, block_rows=block_rows,
                            lanes=lanes)
