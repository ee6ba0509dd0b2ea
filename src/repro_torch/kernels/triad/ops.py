"""Public STREAM Triad op, registered as an ``EngineOp``."""
from __future__ import annotations

import numpy as np
import torch

from ...carry import cast
from ...core.intensity import triad as triad_traits
from ..elementwise_tuning import ELEMENTWISE_TILE_DEFAULTS, ELEMENTWISE_TILE_SPACE
from ..registry import EngineOp, register
from .ref import triad_ref
from .triad import triad_matrix, triad_vector

__all__ = ["TRIAD_OP", "triad"]


def _traits(b, c, q):
    del c, q
    return triad_traits(b.numel(), dsize=b.element_size())


def _make_inputs(rng: np.random.Generator, size: int, dtype: str = "float32",
                 device: str = "cuda"):
    b = cast(rng.standard_normal(size), dtype, device)
    c = cast(rng.standard_normal(size), dtype, device)
    return (b, c, 1.5), {}


TRIAD_OP = register(EngineOp(
    name="triad",
    traits=_traits,
    engines={"vector": triad_vector, "matrix": triad_matrix},
    reference=triad_ref,
    make_inputs=_make_inputs,
    bench_sizes=(2**18, 2**20, 2**22),
    dtypes=("float32", "bfloat16"),
    test_size=300_000,
    doc="STREAM Triad a = b + q*c; I = 2/(3D), memory-bound everywhere",
    tile_space=ELEMENTWISE_TILE_SPACE,
    tile_defaults=ELEMENTWISE_TILE_DEFAULTS,
))


def triad(b: torch.Tensor, c: torch.Tensor, q, *, engine: str = "auto",
          backend: str = "cuda") -> torch.Tensor:
    """a = b + q * c for arbitrary same-shaped b, c."""
    return TRIAD_OP(b, c, q, engine=engine, backend=backend)
