"""Gradient compression for the data-parallel all-reduce.

The reference casts the gradients to bfloat16 or int8 (per-tensor
scale) and back before they leave the backward pass, so the all-reduce
moves the narrower payload; an error-feedback variant keeps the
quantization error and adds it to the next step's gradients.  On one
device the round trip alone remains: the same values, no collective.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .tree import leaves, tree_map

__all__ = ["compress_decompress", "compress_in_place",
           "compress_with_feedback", "init_residual"]


def _q_int8(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(g.abs().amax(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def _round_trip(method: str):
    if method == "bf16":
        return lambda g: g.to(torch.bfloat16).to(g.dtype)
    if method == "int8":
        return _q_int8
    raise ValueError(f"unknown compression {method!r}")


def compress_decompress(grads: Any, method: str) -> Any:
    """The gradient tree after a lossy round trip: ``"bf16"`` or
    ``"int8"``."""
    return tree_map(_round_trip(method), grads)


@torch.no_grad()
def compress_in_place(grads: Any, method: str) -> Any:
    """``compress_decompress``, each leaf overwritten (a leaf's worth of
    scratch, not a second tree).  Returns ``grads``."""
    fn = _round_trip(method)
    for g in leaves(grads):
        g.copy_(fn(g))
    return grads


def compress_with_feedback(grads: Any, residual: Any, method: str
                           ) -> Tuple[Any, Any]:
    """Error feedback: quantize (grad + residual), keep the error as the
    next residual."""
    summed = tree_map(torch.add, grads, residual)
    quant = compress_decompress(summed, method)
    return quant, tree_map(torch.sub, summed, quant)


def init_residual(params: Any) -> Any:
    """A zero residual of the parameters' shape."""
    return tree_map(torch.zeros_like, params)
