"""Public SCALE op, registered as an ``EngineOp`` (paper Fig. 6)."""
from __future__ import annotations

import numpy as np
import torch

from ...carry import cast
from ...core.intensity import scale as scale_traits
from ..elementwise_tuning import ELEMENTWISE_TILE_DEFAULTS, ELEMENTWISE_TILE_SPACE
from ..registry import EngineOp, register
from .ref import scale_ref
from .scale import scale_matrix, scale_vector

__all__ = ["SCALE_OP", "scale"]


def _traits(b, q):
    del q
    return scale_traits(b.numel(), dsize=b.element_size())


def _make_inputs(rng: np.random.Generator, size: int, dtype: str = "float32",
                 device: str = "cuda"):
    b = cast(rng.standard_normal(size), dtype, device)
    return (b, 1.5), {}


SCALE_OP = register(EngineOp(
    name="scale",
    traits=_traits,
    engines={"vector": scale_vector, "matrix": scale_matrix},
    reference=scale_ref,
    make_inputs=_make_inputs,
    bench_sizes=(2**18, 2**20, 2**22),
    dtypes=("float32", "bfloat16"),
    test_size=300_000,
    doc="STREAM SCALE a = q*b; I = 1/(2D), memory-bound everywhere",
    tile_space=ELEMENTWISE_TILE_SPACE,
    tile_defaults=ELEMENTWISE_TILE_DEFAULTS,
))


def scale(b: torch.Tensor, q, *, engine: str = "auto",
          backend: str = "cuda") -> torch.Tensor:
    """a = q * b for arbitrary-shaped b.

    engine: 'auto' (paper §6 advisor -> vector, since I=1/(2D) is far below
    machine balance), 'vpu', or 'mxu' (paper Fig.-5 A = B(qI)).
    """
    return SCALE_OP(b, q, engine=engine, backend=backend)
