"""Public SpMV op (block-ELL), registered as an ``EngineOp``.

SpMV declares no ``tile_space``: its (bm, bn) blocking is baked into the
BlockEll *data layout* by ``dense_to_bell``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.intensity import spmv_bell as bell_traits
from ..registry import EngineOp, register
from .ref import BlockEll, bell_matvec_ref, dense_to_bell
from .spmv import bell_spmv_bell

__all__ = ["SPMV_OP", "spmv", "BlockEll", "dense_to_bell"]


def _traits(bell: BlockEll, x):
    del x
    nbr, mb, bm, bn = bell.blocks.shape
    m, n = bell.shape
    return bell_traits(m, n, nbr * mb, bm, bn,
                       dsize=bell.blocks.element_size())


def _make_inputs(rng: np.random.Generator, size: int, dtype: str = "float32",
                 device: str = "cuda"):
    """size = row count; a ~5%-dense random matrix with 2x wider columns."""
    m = max(8, (size // 8) * 8)
    n = max(128, (2 * size // 128) * 128)
    a = torch.from_numpy(rng.standard_normal((m, n)).astype(dtype))
    keep = torch.from_numpy(rng.random((m, n)) < 0.05)
    a = (a.to(device) * keep.to(device)).to(getattr(torch, dtype))
    bell = dense_to_bell(a, bm=8, bn=128)
    x = torch.from_numpy(rng.standard_normal(n)).to(getattr(torch, dtype))
    return (bell, x.to(device)), {}


SPMV_OP = register(EngineOp(
    name="spmv",
    traits=_traits,
    engines={
        "vector": functools.partial(bell_spmv_bell, engine="vector"),
        "matrix": functools.partial(bell_spmv_bell, engine="matrix"),
    },
    reference=bell_matvec_ref,
    make_inputs=_make_inputs,
    bench_sizes=(256, 512),
    test_size=128,
    doc="block-ELL SpMV y = A x; I ~ 1/(2D) per stored element",
    shard_kind="rowblock",
))


def spmv(bell: BlockEll, x: torch.Tensor, *, engine: str = "auto",
         backend: str = "cuda") -> torch.Tensor:
    """y = A x, A in block-ELL.

    'auto' consults the paper's advisor with the format's true traits;
    block-ELL SpMV intensity is ~1/(2D) per stored block element, far
    below machine balance, so auto -> vector engine.
    """
    return SPMV_OP(bell, x, engine=engine, backend=backend)
