"""The expert share's grouped SwiGLU: each held expert's product over the
rows routed to it, and no other.

``grouped_swiglu`` launches ``csrc/experts.cu`` (through ``_ext.experts``)
for tensors on the card, and runs the plain version for tensors on the
CPU; it never falls back.  The rows come sorted by held expert, expert
e's at ``offsets[e] .. offsets[e + 1]``, with ``offsets`` a tensor beside
them: the kernel reads the counts on the card, so the host never waits
for them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["grouped_swiglu", "grouped_swiglu_plain"]


def grouped_swiglu(xs: torch.Tensor, offsets: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """y (P, D): ``(silu(x W_gate[e]) * (x W_up[e])) W_down[e]`` for each
    row x of ``xs`` (P, D) routed to held expert e; the rows past
    ``offsets[-1]`` hold no result (the kernel leaves them unwritten)."""
    if xs.is_cuda:
        from . import _ext
        return _ext.experts(xs, offsets.to(torch.int32), w_gate, w_up,
                            w_down)
    return grouped_swiglu_plain(xs, offsets, w_gate, w_up, w_down)


def grouped_swiglu_plain(xs: torch.Tensor, offsets: torch.Tensor,
                         w_gate: torch.Tensor, w_up: torch.Tensor,
                         w_down: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic, one expert at a time (reads the counts on
    the host); rows past ``offsets[-1]`` are 0."""
    y = torch.zeros((xs.shape[0], w_down.shape[-1]), dtype=xs.dtype,
                    device=xs.device)
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            x = xs[lo:hi]
            y[lo:hi] = (F.silu(x @ w_gate[e]) * (x @ w_up[e])) @ w_down[e]
    return y
