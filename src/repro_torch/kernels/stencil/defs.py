"""Stencil definitions for the paper's benchmark suite (Table 3).

Every spec carries two equivalent descriptions:
  * (offsets, weights)    -- used by the oracle and the vector kernel,
  * per-axis 1D factors   -- used by the matrix banded-matmul kernel.

Star stencils decompose exactly into per-axis 1D passes + a center term.
Box stencils are representable as banded matmuls only when separable, so
the suite's box entries (2d9pt, 2d49pt, 3d27pt) use separable weights
(outer products of 1D kernels).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    name: str
    ndim: int
    radius: int
    kind: str                                   # "star" | "box"
    offsets: Tuple[Tuple[int, ...], ...]
    weights: Tuple[float, ...]
    axis_weights: Tuple[Tuple[float, ...], ...]  # per-axis 1D factors
    center: float                                # star-only center weight

    @property
    def num_points(self) -> int:
        return len(self.offsets)


def _star(name: str, ndim: int, radius: int,
          wing: Tuple[float, ...], center: float) -> StencilSpec:
    """Star: offsets along each axis only.  wing = weights at distance 1..r
    (same both directions and all axes, as in the classic suites)."""
    offsets = [(0,) * ndim]
    weights = [center]
    for ax in range(ndim):
        for d in range(1, radius + 1):
            for sign in (-1, 1):
                off = [0] * ndim
                off[ax] = sign * d
                offsets.append(tuple(off))
                weights.append(wing[d - 1])
    # per-axis 1D factor with zero center (center handled once, globally)
    axis_w = tuple(
        tuple([wing[abs(d) - 1] if d != 0 else 0.0
               for d in range(-radius, radius + 1)])
        for _ in range(ndim))
    return StencilSpec(name, ndim, radius, "star", tuple(offsets),
                       tuple(weights), axis_w, center)


def _box_separable(name: str, ndim: int, radius: int,
                   w1d: Tuple[float, ...]) -> StencilSpec:
    """Box with separable weights w[p1,..,pk] = prod_i w1d[pi+r]."""
    assert len(w1d) == 2 * radius + 1
    offsets, weights = [], []
    for off in itertools.product(range(-radius, radius + 1), repeat=ndim):
        offsets.append(off)
        w = 1.0
        for d in off:
            w *= w1d[d + radius]
        weights.append(w)
    return StencilSpec(name, ndim, radius, "box", tuple(offsets),
                       tuple(weights), tuple(w1d for _ in range(ndim)), 0.0)


def suite() -> Dict[str, StencilSpec]:
    """The paper's Table-3 suite with fixed, reproducible weights."""
    return {
        "2d5pt": _star("2d5pt", 2, 1, (0.15,), 0.4),
        "2d13pt": _star("2d13pt", 2, 3, (0.11, 0.05, 0.02), 0.28),
        "2d9pt": _box_separable("2d9pt", 2, 1, (0.2, 0.6, 0.2)),
        "2d49pt": _box_separable("2d49pt", 2, 3,
                                 (0.03, 0.07, 0.2, 0.4, 0.2, 0.07, 0.03)),
        "3d7pt": _star("3d7pt", 3, 1, (0.1,), 0.4),
        "3d27pt": _box_separable("3d27pt", 3, 1, (0.25, 0.5, 0.25)),
    }


# paper Table 3: temporal-blocking depth used per benchmark
TABLE3_DEPTH = {"2d5pt": 3, "2d13pt": 1, "2d9pt": 3, "2d49pt": 1,
                "3d7pt": 3, "3d27pt": 3}
