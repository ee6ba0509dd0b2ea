"""STREAM Triad entry points, one per engine.

Triad (``a = b + q*c``) is the canonical STREAM kernel with a fused
multiply-add: I = 2/(3D), far below every machine balance in the paper's
Table 1.  Matrix engine: the Fig.-5 identity trick extended to two
terms, ``A = B I + C (qI)`` -- one tensor-core product per term, each
rounded to float32, summed in float32.  Both launch
``csrc/elementwise.cu``.
"""
from __future__ import annotations

import torch

from ...core.dispatch import elementwise_call


def triad_vector(b: torch.Tensor, c: torch.Tensor, q, *,
                 backend: str = "cuda", block_rows: int = None,
                 lanes: int = None) -> torch.Tensor:
    """a = b + q * c on the CUDA cores."""
    return elementwise_call("triad", c, q, b, engine="vector",
                            backend=backend, block_rows=block_rows,
                            lanes=lanes)


def triad_matrix(b: torch.Tensor, c: torch.Tensor, q, *,
                 backend: str = "cuda", block_rows: int = None,
                 lanes: int = None) -> torch.Tensor:
    """a = B I + C (qI) on the tensor cores."""
    return elementwise_call("triad", c, q, b, engine="matrix",
                            backend=backend, block_rows=block_rows,
                            lanes=lanes)
