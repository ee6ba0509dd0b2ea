"""Temporally blocked stencil entry point, one kernel per engine (paper §5.3).

  * vector kernel = the EBISU/Brick role: shifted multiply-adds on a
    shared-memory tile, with in-kernel *temporal blocking* (t fused
    steps, trapezoid halo t*r);
  * matrix kernel = the ConvStencil role: each fused step is a set of
    banded products on the FP64 tensor cores (star: one 1-D pass per
    axis + centre term; separable box: product of 1-D passes).

Both are ``csrc/stencil.cu``; ``stencil_plain`` is their plain PyTorch
version, computed on the whole domain with the same rounding points.
"""
from __future__ import annotations

import torch

from ...core.dispatch import check_backend
from .defs import StencilSpec
from .ref import shift_zero


def _axis_pass(u: torch.Tensor, w1d, axis: int) -> torch.Tensor:
    """Banded product along ``axis``, accumulated in float64, rounded once."""
    r = (len(w1d) - 1) // 2
    acc = torch.zeros_like(u, dtype=torch.float64)
    for d, w in enumerate(w1d):
        if w == 0.0:
            continue
        off = [0] * u.ndim
        off[axis] = d - r
        w32 = float(torch.tensor(w, dtype=torch.float32))
        acc = acc + w32 * shift_zero(u, off).double()
    return acc.to(u.dtype)


def _vector_step(u: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """One step of fused multiply-adds in the spec's order; the float64
    product is exact, so one float64 sum rounded to float32 is the FMA."""
    acc = torch.zeros_like(u)
    for off, w in zip(spec.offsets, spec.weights):
        w32 = float(torch.tensor(w, dtype=torch.float32))
        acc = (acc.double() + w32 * shift_zero(u, off).double()).to(u.dtype)
    return acc


def _matrix_step(u: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    if spec.kind == "star":
        acc = torch.tensor(spec.center, dtype=u.dtype) * u
        for ax in range(spec.ndim):
            acc = acc + _axis_pass(u, spec.axis_weights[ax], ax)
        return acc
    out = u
    for ax in range(spec.ndim):
        out = _axis_pass(out, spec.axis_weights[ax], ax)
    return out


def stencil_plain(u: torch.Tensor, spec: StencilSpec, *, steps: int = 1,
                  engine: str = "vector") -> torch.Tensor:
    """Plain PyTorch version of the stencil kernels (zero boundary).

    Vector: the spec's shifted fused multiply-adds in the spec's order.  Matrix:
    per-axis banded passes, each summed in float64 and rounded to float32,
    star = centre * u + passes, box = product of passes.
    """
    step = _vector_step if engine == "vector" else _matrix_step
    for _ in range(steps):
        u = step(u, spec)
    return u


def stencil_apply(u: torch.Tensor, spec: StencilSpec, *, steps: int = 1,
                  engine: str = "vector", block_rows: int = 128,
                  backend: str = "cuda") -> torch.Tensor:
    """Apply `spec` to u for `steps` fused timesteps on the chosen engine.

    ``block_rows`` is the leading-axis extent one CTA covers; it must hold
    the halo ``steps * spec.radius``.
    """
    if u.ndim != spec.ndim:
        raise ValueError(f"{spec.ndim}-D stencil on a {u.ndim}-D array")
    if steps * spec.radius > block_rows:
        raise ValueError("halo must fit one leading block")
    check_backend(backend, u)
    if backend == "plain":
        return stencil_plain(u, spec, steps=steps, engine=engine)
    from .. import _ext
    return _ext.stencil(u, spec, steps=steps, engine=engine,
                        block_rows=block_rows)
