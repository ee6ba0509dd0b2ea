"""Public AXPY op, registered as an ``EngineOp``."""
from __future__ import annotations

import numpy as np
import torch

from ...carry import cast
from ...core.intensity import axpy as axpy_traits
from ..elementwise_tuning import ELEMENTWISE_TILE_DEFAULTS, ELEMENTWISE_TILE_SPACE
from ..registry import EngineOp, register
from .axpy import axpy_matrix, axpy_vector
from .ref import axpy_ref

__all__ = ["AXPY_OP", "axpy"]


def _traits(a, x, y):
    del a, y
    return axpy_traits(x.numel(), dsize=x.element_size())


def _make_inputs(rng: np.random.Generator, size: int, dtype: str = "float32",
                 device: str = "cuda"):
    x = cast(rng.standard_normal(size), dtype, device)
    y = cast(rng.standard_normal(size), dtype, device)
    return (0.75, x, y), {}


AXPY_OP = register(EngineOp(
    name="axpy",
    traits=_traits,
    engines={"vector": axpy_vector, "matrix": axpy_matrix},
    reference=axpy_ref,
    make_inputs=_make_inputs,
    bench_sizes=(2**18, 2**20, 2**22),
    dtypes=("float32", "bfloat16"),
    test_size=300_000,
    doc="AXPY y = a*x + y; I = 2/(3D), memory-bound everywhere",
    tile_space=ELEMENTWISE_TILE_SPACE,
    tile_defaults=ELEMENTWISE_TILE_DEFAULTS,
))


def axpy(a, x: torch.Tensor, y: torch.Tensor, *, engine: str = "auto",
         backend: str = "cuda") -> torch.Tensor:
    """y = a * x + y for arbitrary same-shaped x, y."""
    return AXPY_OP(a, x, y, engine=engine, backend=backend)
