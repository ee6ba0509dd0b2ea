"""Oracles for SpMV (paper §3.2) + the block-ELL format.

The CSR oracle mirrors the cuSPARSE baseline; ``bell_matvec_ref``
densifies a block-ELL matrix and multiplies -- the ground truth both
engine kernels must match.
"""
from __future__ import annotations

import dataclasses

import torch


def csr_spmv_ref(indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, x: torch.Tensor, m: int) -> torch.Tensor:
    """y = A x with A in CSR, via a segment sum (the vector-engine shape)."""
    nnz = data.shape[0]
    row_of = torch.searchsorted(indptr, torch.arange(nnz, device=data.device),
                                right=True) - 1
    prod = data * x[indices.long()]
    return torch.zeros(m, dtype=data.dtype, device=data.device).index_add_(
        0, row_of, prod)


@dataclasses.dataclass
class BlockEll:
    """Block-ELL: each block-row stores a fixed number of dense blocks.

    blocks: (n_block_rows, max_blocks, bm, bn) values (zero-padded)
    cols:   (n_block_rows, max_blocks) int32 block-column ids (0-padded)
    shape:  dense (m, n)
    """
    blocks: torch.Tensor
    cols: torch.Tensor
    shape: tuple

    @property
    def bm(self) -> int:
        return self.blocks.shape[2]

    @property
    def bn(self) -> int:
        return self.blocks.shape[3]

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        nbr, mb, bm, bn = self.blocks.shape
        # one scatter-add into (nbr, n_block_cols, bm, bn): duplicate block
        # columns accumulate
        grid = torch.zeros((nbr, n // bn, bm, bn), dtype=self.blocks.dtype,
                           device=self.blocks.device)
        rows = torch.arange(nbr, device=self.cols.device)[:, None].expand(
            nbr, mb)
        grid.index_put_((rows, self.cols.long()), self.blocks,
                        accumulate=True)
        return grid.permute(0, 2, 1, 3).reshape(m, n)


def dense_to_bell(a, bm: int = 8, bn: int = 128) -> BlockEll:
    """Convert a dense matrix (numpy array or tensor) into block-ELL.

    Blocks that are entirely zero are dropped; the kept blocks of a
    block-row come in ascending column order, and every block-row is
    padded to the max block count with explicit zero blocks at column 0
    (safe: zero values contribute nothing).  Vectorised: a 512 MiB matrix
    converts in one pass on its device.
    """
    a = torch.as_tensor(a)
    m, n = a.shape
    if m % bm or n % bn:
        raise ValueError(f"{(m, n)} is not a multiple of the {bm}x{bn} block")
    nbr, nbc = m // bm, n // bn
    tiles = a.reshape(nbr, bm, nbc, bn).permute(0, 2, 1, 3)
    nonzero = (tiles != 0).any(dim=3).any(dim=2)            # (nbr, nbc)
    counts = nonzero.sum(dim=1)
    max_blocks = max(1, int(counts.max())) if nbr else 1
    # stable sort puts the non-zero block columns first, ascending
    order = torch.sort((~nonzero).to(torch.uint8), dim=1,
                       stable=True).indices[:, :max_blocks]
    slot = torch.arange(max_blocks, device=a.device)
    keep = slot[None, :] < counts[:, None]
    cols = torch.where(keep, order, torch.zeros_like(order))
    rows = torch.arange(nbr, device=a.device)[:, None]
    blocks = tiles[rows, cols] * keep[:, :, None, None].to(a.dtype)
    return BlockEll(blocks.contiguous(), cols.to(torch.int32).contiguous(),
                    (m, n))


def bell_matvec_ref(bell: BlockEll, x: torch.Tensor) -> torch.Tensor:
    """Oracle: densify then multiply."""
    return bell.todense() @ x
