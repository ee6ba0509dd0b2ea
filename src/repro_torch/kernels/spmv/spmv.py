"""Block-ELL SpMV entry points, one per engine (paper §5.2).

Both engines consume the same block-ELL layout and differ only in the
per-block compute (``csrc/spmv.cu``):

  vector engine: 16-byte loads, multiply-adds and a warp shuffle reduce
                 on the CUDA cores                      (cuSPARSE role)
  matrix engine: DMMA m8n8k4 with x in one column of B  (DASP role)

The matrix kernel uses 1/8 of each MMA's output columns -- the paper's
1/8-utilization observation, kept on purpose.
"""
from __future__ import annotations

import torch

from ...core.dispatch import check_backend
from .ref import BlockEll


def spmv_plain(blocks: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
               *, engine: str = "vector") -> torch.Tensor:
    """Plain PyTorch version of the SpMV kernels; returns (nbr, bm).

    One float32 dot per stored block, summed over the block slots in
    float32, as the reference accumulates its output block; the matrix
    engine's per-block dot is taken in float64 (the DMMA accumulator).
    """
    nbr, mb, bm, bn = blocks.shape
    xg = x.reshape(-1, bn)[cols.long()]                    # (nbr, mb, bn)
    if engine == "matrix":
        per_block = torch.einsum("ijrc,ijc->ijr", blocks.double(),
                                 xg.double()).float()
    else:
        per_block = (blocks * xg[:, :, None, :]).sum(dim=3)
    return per_block.sum(dim=1)


def bell_spmv(blocks: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
              engine: str = "vector", backend: str = "cuda") -> torch.Tensor:
    """y = A x for A in block-ELL; returns (n_block_rows, bm)."""
    if x.shape[0] % blocks.shape[3]:
        raise ValueError(f"x length {x.shape[0]} is not a multiple of the "
                         f"block width {blocks.shape[3]}")
    check_backend(backend, blocks, cols, x)
    if backend == "plain":
        return spmv_plain(blocks, cols, x, engine=engine)
    from .. import _ext
    return _ext.spmv(blocks, cols, x, engine=engine)


def bell_spmv_bell(bell: BlockEll, x: torch.Tensor, *,
                   engine: str = "vector", backend: str = "cuda"
                   ) -> torch.Tensor:
    """y = A x for a ``BlockEll``; returns the dense (m,) result."""
    y = bell_spmv(bell.blocks, bell.cols, x, engine=engine, backend=backend)
    return y.reshape(-1)[:bell.shape[0]]
