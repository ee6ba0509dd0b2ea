"""STREAM SCALE entry points, one per engine (paper §5.1).

Vector engine: one load, one multiply, one store per element on the CUDA
cores.  Matrix engine: the paper's Fig.-5 formulation ``A = B (qI)``,
every element multiplied through a tensor-core MMA against a scaled
identity fragment.  Both launch ``csrc/elementwise.cu`` through
``repro_torch.core.dispatch.elementwise_call``; on CPU tensors with
``backend="plain"`` they run its plain PyTorch version.
"""
from __future__ import annotations

import torch

from ...core.dispatch import elementwise_call


def scale_vector(b: torch.Tensor, q, *, backend: str = "cuda",
                 block_rows: int = None, lanes: int = None) -> torch.Tensor:
    """a = q * b on the CUDA cores."""
    return elementwise_call("scale", b, q, engine="vector",
                            backend=backend, block_rows=block_rows,
                            lanes=lanes)


def scale_matrix(b: torch.Tensor, q, *, backend: str = "cuda",
                 block_rows: int = None, lanes: int = None) -> torch.Tensor:
    """a = B (qI) on the tensor cores."""
    return elementwise_call("scale", b, q, engine="matrix",
                            backend=backend, block_rows=block_rows,
                            lanes=lanes)
