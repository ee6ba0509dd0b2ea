"""Operational-intensity formulas for the paper's workloads (paper §3).

Every formula returns (W flops, Q bytes, I flop/byte) so the same objects
feed the roofline (Eq. 3), the boundedness test (Eq. 4), and the speedup
bounds (Eq. 19-24).  D is the element size in bytes (paper uses FP64, D=8);
IDX is the index size (4-byte int in CSR).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class KernelTraits:
    name: str
    work_flops: float     # W
    traffic_bytes: float  # Q

    @property
    def intensity(self) -> float:
        return self.work_flops / self.traffic_bytes


# --- SCALE (paper §3.1) ------------------------------------------------------

def scale(n: int, dsize: int = 8) -> KernelTraits:
    """a_i = q * b_i: one load + one store + one mul per element.

    W = n, Q = 2*n*D, I = 1/(2D)  -> 1/16 for FP64.
    """
    return KernelTraits("SCALE", float(n), 2.0 * n * dsize)


def triad(n: int, dsize: int = 8) -> KernelTraits:
    """STREAM Triad a_i = b_i + q * c_i: two loads + one store, mul+add.

    W = 2n, Q = 3*n*D, I = 2/(3D)  -> 1/12 for FP64.
    """
    return KernelTraits("TRIAD", 2.0 * n, 3.0 * n * dsize)


def axpy(n: int, dsize: int = 8) -> KernelTraits:
    """AXPY y_i = a * x_i + y_i: two loads + one store, mul+add.

    Same roofline position as Triad: W = 2n, Q = 3*n*D, I = 2/(3D).
    """
    return KernelTraits("AXPY", 2.0 * n, 3.0 * n * dsize)


# --- GEMV / SpMV (paper §3.2) ------------------------------------------------

def gemv(m: int, n: int, dsize: int = 8) -> KernelTraits:
    """y = A x: W = 2mn, Q = (mn + m + n) * D, I ~= 2/D = 1/4 for FP64."""
    return KernelTraits(
        "GEMV", 2.0 * m * n, float(m * n + m + n) * dsize)


def spmv_csr(m: int, n: int, nnz: int, dsize: int = 8,
             isize: int = 4) -> KernelTraits:
    """CSR SpMV (paper Eq. 10).

    W = 2*nnz
    Q = (nnz + m + n)*D + (nnz + m + 1)*I  ->  I ~= 2/(D+I) = 1/6 for FP64.
    """
    work = 2.0 * nnz
    traffic = (nnz + m + n) * dsize + (nnz + m + 1) * isize
    return KernelTraits("SpMV-CSR", work, float(traffic))


def spmv_bell(m: int, n: int, nnz_blocks: int, bm: int, bn: int,
              dsize: int = 4, isize: int = 4) -> KernelTraits:
    """Block-ELL SpMV (the repo's dense-block sparse format).

    Each stored block is dense bm x bn; the index stream is one int per block.
    W = 2 * nnz_blocks * bm * bn
    Q = nnz_blocks * (bm*bn*D + I) + (m + n) * D
    """
    work = 2.0 * nnz_blocks * bm * bn
    traffic = nnz_blocks * (bm * bn * dsize + isize) + (m + n) * dsize
    return KernelTraits("SpMV-BELL", work, float(traffic))


# --- Stencil (paper §3.3) ------------------------------------------------------

def stencil(num_points: int, t: int = 1, dsize: int = 8,
            npoints_domain: int = 1) -> KernelTraits:
    """|S|-point stencil with temporal blocking depth t (paper Eq. 12-13).

    Per domain point: Q = 2*D (ideal: one load of u, one store of v),
    W = t * 2 * |S|  (mul+add per tap, t fused timesteps).
    I = t * |S| / D.
    """
    work = t * 2.0 * num_points * npoints_domain
    traffic = 2.0 * dsize * npoints_domain
    return KernelTraits(f"stencil-{num_points}pt(t={t})", work, traffic)


def stencil_matmul(num_points: int, radius: int, tile: int = 128, t: int = 1,
                   dsize: int = 4) -> KernelTraits:
    """Banded-matmul (matrix-engine) formulation of a 2D star stencil.

    Each axis pass multiplies the tile by an L x L banded matrix: W inflates
    from 2|S| to ~2*2*L per point (two axis passes), independent of |S|.
    Traffic is unchanged (same loads/stores) -- the essence of the
    ConvStencil-style transform: full matrix-engine use, wasted flops.
    """
    del num_points, radius  # W no longer depends on them: that's the waste
    work_per_point = t * 2.0 * 2.0 * tile
    return KernelTraits(f"stencil-matmul(L={tile},t={t})",
                        work_per_point, 2.0 * dsize)


def temporal_depth_to_compute_bound(num_points: int, balance: float,
                                    dsize: int = 8) -> float:
    """Paper Eq. 14: smallest t with t * |S|/D > B."""
    return balance * dsize / num_points


# --- convenience ---------------------------------------------------------------

def paper_table(dsize: int = 8) -> Tuple[KernelTraits, ...]:
    """The kernels of paper Fig. 2, FP64."""
    return (
        scale(1, dsize),
        gemv(4096, 4096, dsize),
        spmv_csr(4096, 4096, 9 * 4096, dsize),
        stencil(5, 1, dsize),
        stencil(13, 1, dsize),
        stencil(9, 3, dsize),
        stencil(49, 1, dsize),
    )
