"""Public stencil op, registered as an ``EngineOp`` (temporal-blocking
aware: the advisor sees the blocked intensity I_t = t*|S|/D)."""
from __future__ import annotations

import numpy as np
import torch

from ...carry import cast
from ...core.intensity import stencil as stencil_traits
from ..registry import EngineOp, register
from .defs import TABLE3_DEPTH, StencilSpec, suite
from .ref import stencil_ref
from .stencil import stencil_apply

__all__ = ["STENCIL_OP", "stencil", "suite", "TABLE3_DEPTH", "StencilSpec"]

#: Static leading-axis block height (``stencil_apply``'s default).
DEFAULT_BLOCK_ROWS = 128

#: Leading-axis block heights a tuner may try.
STENCIL_TILE_SPACE = {"block_rows": (32, 64, 128, 256)}


def _traits(u, spec: StencilSpec, *, steps: int = 1, block_rows=None):
    del block_rows
    return stencil_traits(spec.num_points, t=steps, dsize=u.element_size(),
                          npoints_domain=u.numel())


def _reference(u, spec: StencilSpec, *, steps: int = 1, block_rows=None):
    del block_rows  # implementation tiling knob; the oracle has none
    return stencil_ref(u, spec, steps=steps)


def _make_inputs(rng: np.random.Generator, size: int, dtype: str = "float32",
                 device: str = "cuda"):
    """size = 2D domain side; the Table-3 5-point star at its paper depth."""
    spec = suite()["2d5pt"]
    u = cast(rng.standard_normal((size, size)), dtype, device)
    return (u, spec), {"steps": TABLE3_DEPTH["2d5pt"]}


def _engine_fn(engine: str):
    def call(u, spec: StencilSpec, *, steps: int = 1, block_rows=None,
             backend: str = "cuda"):
        br = DEFAULT_BLOCK_ROWS if block_rows is None else int(block_rows)
        # a block must contain its own halo (t*r rows each side); clamp up
        br = max(br, steps * spec.radius)
        return stencil_apply(u, spec, steps=steps, engine=engine,
                             block_rows=br, backend=backend)
    return call


STENCIL_OP = register(EngineOp(
    name="stencil",
    traits=_traits,
    engines={
        "vector": _engine_fn("vector"),
        "matrix": _engine_fn("matrix"),
    },
    reference=_reference,
    make_inputs=_make_inputs,
    bench_sizes=(128, 256),
    test_size=48,
    doc="|S|-point stencil, t fused steps; I_t = t*|S|/D (paper Eq. 13)",
    tile_space=STENCIL_TILE_SPACE,
    tile_defaults={"block_rows": DEFAULT_BLOCK_ROWS},
    shard_kind="rowblock",
    shard_halo=lambda u, spec, steps=1, **kw: steps * spec.radius,
))


def stencil(u: torch.Tensor, spec: StencilSpec, *, steps: int = 1,
            engine: str = "auto", block_rows: int = None,
            backend: str = "cuda") -> torch.Tensor:
    """Apply `spec` for `steps` fused timesteps.

    'auto' consults the advisor with the *temporally blocked* intensity
    I_t = t * |S| / D (paper Eq. 13).  ``block_rows`` is the leading-axis
    tile height; None means the static default of 128.
    """
    kwargs = {} if block_rows is None else {"block_rows": block_rows}
    return STENCIL_OP(u, spec, steps=steps, engine=engine, backend=backend,
                      **kwargs)
