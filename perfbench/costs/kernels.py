"""Bytes and operations of one call of each kernel family, from its
shapes: ``(bytes, flops)``.  Each input read once, each output written
once."""
from __future__ import annotations

from typing import Sequence, Tuple


def scale(n: int, esize: int) -> Tuple[float, float]:
    """SCALE ``a = q b``: b read, a written; one multiply per element."""
    return 2.0 * n * esize, float(n)


def triad(n: int, esize: int) -> Tuple[float, float]:
    """STREAM Triad ``a = b + q c``: b and c read, a written; a multiply
    and an add per element."""
    return 3.0 * n * esize, 2.0 * n


def spmv_bell(n_block_rows: int, blocks_per_row: int, bm: int, bn: int,
              n_cols: int, esize: int = 4, isize: int = 4
              ) -> Tuple[float, float]:
    """Block-ELL SpMV ``y = A x`` with the arrays as given: every stored
    block and its column index, x and y once; a multiply-add per stored
    element."""
    stored = n_block_rows * blocks_per_row
    nbytes = stored * (bm * bn * esize + isize) + (n_cols +
                                                   n_block_rows * bm) * esize
    return float(nbytes), 2.0 * stored * bm * bn


def stencil(points: int, steps: int, shape: Sequence[int], esize: int
            ) -> Tuple[float, float]:
    """``steps`` fused steps of a ``points``-point stencil over a domain:
    the domain read and written once; a multiply-add per point, step and
    element."""
    n = 1
    for d in shape:
        n *= int(d)
    return 2.0 * n * esize, 2.0 * points * steps * n


def flash_decode(b: int, kh: int, g: int, dh: int, s: int, kv_len: int,
                 esize: int) -> Tuple[float, float]:
    """Single-token GQA attention over a cache of ``s`` positions: K and V
    of the valid positions (all ``s`` when ``kv_len <= 0``), q read and
    the output written; two multiply-adds per query head, position and
    head-dim element (scores and the weighted sum)."""
    used = min(kv_len, s) if kv_len >= 1 else s
    nbytes = (2 * b * used * kh * dh + 2 * b * kh * g * dh) * esize
    return float(nbytes), 4.0 * b * kh * g * used * dh
