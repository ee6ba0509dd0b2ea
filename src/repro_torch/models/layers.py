"""Shared building blocks: norms, rotary embeddings, SwiGLU, initializers.

The reference's pure functions over parameter pytrees, over the port's
modules instead (``lm.Block``: a named group of weights).  Parameters
live in float32; compute happens in the caller-chosen dtype.  Matmul
weights are cast to that dtype once, when an engine is built
(``lm.cast_params``), where the reference casts them at every use: the
rounding is the same, and a step does not stream the weights twice.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["apply_mrope", "apply_rope", "dense_init", "init_mlp", "mlp",
           "rmsnorm", "rope_frequencies"]


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, device="cuda") -> torch.Tensor:
    """A (d_in, d_out) float32 weight for ``x @ W``, N(0, scale^2).

    Drawn on ``device`` from ``gen`` (a generator on that device), so a
    full-size model is made where it runs.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device="cpu"
                     ) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (half,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    positions: (3, ..., S) -- temporal/height/width position ids.  The
    rotary half-dim is split into ``sections`` (t, h, w); each section
    takes its angle from the corresponding position stream.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    streams = positions[..., None].float() * freqs            # (3,...,S,half)
    parts, start = [], 0
    for idx, sec in enumerate(sections):
        parts.append(streams[idx][..., start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))


# --------------------------------------------------------------------------
# feed-forward
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, device="cuda"
             ) -> dict:
    return {"w_gate": dense_init(gen, d_model, d_ff, device=device),
            "w_up": dense_init(gen, d_model, d_ff, device=device),
            "w_down": dense_init(gen, d_ff, d_model, device=device)}


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * x W_up) W_down``; weights in x's dtype."""
    g = x @ p.w_gate
    u = x @ p.w_up
    return (F.silu(g) * u) @ p.w_down
