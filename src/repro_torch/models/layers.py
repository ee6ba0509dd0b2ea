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

__all__ = ["apply_mrope", "apply_rope", "apply_rope_freqs", "dense_init",
           "init_mlp", "mlp", "pairs_to_halves", "rmsnorm",
           "rope_frequencies", "yarn_frequencies"]


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


def yarn_frequencies(dim: int, theta: float, factor: float,
                     original_len: int, beta_fast: float, beta_slow: float,
                     device="cpu") -> torch.Tensor:
    """YaRN's inverse frequencies for a rotary dim of ``dim``, as the
    published ``DeepseekV2YarnRotaryEmbedding`` makes them: the plain
    frequencies ``theta ** (-2j / dim)`` on the fast dimensions, those
    divided by ``factor`` on the slow ones, and a linear ramp between
    dimensions ``low`` and ``high``, where a dimension turns ``beta_fast``
    and ``beta_slow`` times over ``original_len`` positions."""
    def corr(rotations: float) -> float:
        return (dim * math.log(original_len / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (factor * theta ** exps)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def pairs_to_halves(x: torch.Tensor) -> torch.Tensor:
    """The last axis from (even, odd) pairs to its even then its odd
    elements, as the published DeepSeek-V2 reorders q_pe and k_pe before
    its rotate-half rotation."""
    return x.unflatten(-1, (x.shape[-1] // 2, 2)).transpose(-1, -2).flatten(-2)


def apply_rope_freqs(x: torch.Tensor, positions: torch.Tensor,
                     freqs: torch.Tensor, mscale: float) -> torch.Tensor:
    """Rotate-half RoPE of x (..., S, H, Dh) at positions (..., S) with the
    inverse frequencies ``freqs`` (Dh / 2,), cos and sin times ``mscale``
    (YaRN's ratio of its two attention factors)."""
    angles = positions[..., None].float() * freqs
    half = x.shape[-1] // 2
    cos = (torch.cos(angles) * mscale)[..., None, :]
    sin = (torch.sin(angles) * mscale)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


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
