"""Carry the reference's call arguments, given as numpy arrays, into the port.

This system has no weights; what crosses between the JAX reference and
the port is data.  ``from_numpy`` turns one reference call's arguments
into the port's: arrays become tensors (bfloat16 crosses as its bit
pattern, never re-rounded), a block-ELL matrix becomes the port's
``BlockEll``, a stencil spec is rebuilt field by field into the port's
own frozen ``StencilSpec``, and scalars pass through.  Objects are
recognised by their fields, so nothing of the reference is imported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["cast", "from_numpy", "tensor"]


def tensor(a: Any, device: str = "cuda") -> torch.Tensor:
    """An array-like as a tensor on ``device``, bit-exact for bfloat16."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                                .view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def cast(a: np.ndarray, dtype: str, device: str = "cuda") -> torch.Tensor:
    """A float64 numpy draw rounded to ``dtype`` on the host, then moved.

    Rounds as ``jnp.asarray(a, dtype)`` does (bfloat16 through float32),
    so a seeded ``make_inputs`` gives the reference's inputs bit for bit.
    """
    return torch.from_numpy(a).to(getattr(torch, dtype)).to(device)


def _carry(x: Any, device: str) -> Any:
    from .kernels.spmv.ref import BlockEll
    from .kernels.stencil.defs import StencilSpec
    if hasattr(x, "blocks") and hasattr(x, "cols") and hasattr(x, "shape"):
        return BlockEll(tensor(x.blocks, device), tensor(x.cols, device),
                        tuple(int(s) for s in x.shape))
    if hasattr(x, "axis_weights") and hasattr(x, "offsets"):
        return StencilSpec(**{f.name: getattr(x, f.name)
                              for f in dataclasses.fields(StencilSpec)})
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return tensor(x, device)
    if isinstance(x, (tuple, list)):
        return type(x)(_carry(e, device) for e in x)
    return x


def from_numpy(args: tuple, kwargs: dict, device: str = "cuda"):
    """One reference call's ``(args, kwargs)`` as the port's."""
    return (tuple(_carry(a, device) for a in args),
            {k: _carry(v, device) for k, v in kwargs.items()})
