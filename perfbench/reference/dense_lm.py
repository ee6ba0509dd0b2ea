"""Reference of a dense GQA decoder (Mistral's layer): plain PyTorch,
float32, no cache, no kernels, no batching tricks.

A layer is ``x + attn(rmsnorm(x))`` then ``x + swiglu(rmsnorm(x))``;
attention has ``n_heads`` query heads over ``n_kv_heads`` K / V heads
(query head ``h`` reads KV head ``h // G``), rotary embeddings with
``rope_theta`` on the rotate-half layout, scale ``1/sqrt(head_dim)`` and
a causal mask; the LM head is untied.  As in the published code, the
rotary angles are float32 products of position and frequency.

``forward`` runs the tokens a window served, at positions after a
history whose K / V rows (already rotated, as a cache holds them) it is
handed layer by layer, and returns the final normed hidden states and
the K / V rows it computed for the tokens.  It works layer by layer and
in blocks of queries, so it fits beside nothing else on the card.
"""
from __future__ import annotations

import math
from typing import Callable, List, Tuple

from . import no_tf32, tf32


def _mm(torch, a, b, precision: str):
    if precision == "tf32":
        return tf32(torch, a) @ tf32(torch, b)
    return a @ b


def rmsnorm(torch, x, w, eps: float):
    """``x / sqrt(mean(x^2) + eps) * w`` over the last axis, float32."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(torch, x, positions, theta: float):
    """Rotate-half RoPE of ``x`` (B, T, heads, Dh) at ``positions`` (T,)."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, device=x.device,
                                        dtype=torch.float32) / dh))
    ang = positions.to(torch.float32)[:, None] * inv[None, :]   # (T, Dh/2)
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None, :]
    half = dh // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def attend(torch, q, hk, hv, k, v, precision: str, q_block: int = 64):
    """Causal attention of ``q`` (B, T, H, Dh) over the history ``hk`` /
    ``hv`` (B, S, KH, Dh) and the tokens' own ``k`` / ``v`` (B, T, KH,
    Dh): every history position and the tokens up to each query's own.
    Returns (B, T, H * Dh)."""
    b, t, h, dh = q.shape
    kh = hk.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(dh)
    ctl = precision == "tf32"

    def r(x):
        return tf32(torch, x) if ctl else x
    # (B, KH, S, Dh) once, so that each block is a batched product
    hk_t, hv_t = (r(x.permute(0, 2, 1, 3).contiguous()) for x in (hk, hv))
    nk_t, nv_t = (r(x.permute(0, 2, 1, 3).contiguous()) for x in (k, v))
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    for s0 in range(0, t, q_block):
        s1 = min(t, s0 + q_block)
        # (B, KH, G * blk, Dh): query head kh * G + g of each position
        qb = q[:, s0:s1].reshape(b, s1 - s0, kh, g, dh)
        qb = r(qb.permute(0, 2, 3, 1, 4).reshape(b, kh, g * (s1 - s0), dh))
        sh = (qb @ hk_t.transpose(-1, -2)) * scale
        sn = (qb @ nk_t.transpose(-1, -2)) * scale
        qpos = torch.arange(s0, s1, device=q.device).repeat(g)
        mask = torch.arange(t, device=q.device)[None, :] > qpos[:, None]
        sn = sn.masked_fill(mask, float("-inf"))
        m = torch.maximum(sh.amax(-1, keepdim=True), sn.amax(-1, keepdim=True))
        ph, pn = torch.exp(sh - m), torch.exp(sn - m)
        den = ph.sum(-1, keepdim=True) + pn.sum(-1, keepdim=True)
        ob = (r(ph) @ hv_t + r(pn) @ nv_t) / den        # (B, KH, G*blk, Dh)
        ob = ob.reshape(b, kh, g, s1 - s0, dh).permute(0, 3, 1, 2, 4)
        out[:, s0:s1] = ob.reshape(b, s1 - s0, h, dh)
        del sh, sn, ph, pn
    return out.reshape(b, t, h * dh)


def forward(torch, cfg: dict, layer_fn: Callable[[int], dict], outer: dict,
            tokens, start: int, history_fn: Callable[[int], Tuple],
            precision: str = "float32"
            ) -> Tuple[object, List[object], List[object]]:
    """Hidden states after the final norm (B, T, d) of ``tokens`` (B, T)
    at positions ``start .. start + T - 1``, and per layer the K and V
    rows (B, T, KH, Dh) they wrote.  ``layer_fn(i)`` gives layer i's
    weights (``attn.wq`` ..., ``mlp.w_gate`` ..., ``ln1``, ``ln2``),
    ``history_fn(i)`` its history K and V; ``outer`` the embedding, the
    final norm and the head."""
    no_tf32(torch)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h, kh, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    b, t = tokens.shape
    pos = torch.arange(start, start + t, device=tokens.device)
    x = outer["embed"][tokens]
    new_k, new_v = [], []
    for i in range(cfg["num_hidden_layers"]):
        w = layer_fn(i)
        hs = rmsnorm(torch, x, w["ln1"], eps)
        q = _mm(torch, hs, w["attn.wq"], precision).view(b, t, h, dh)
        k = _mm(torch, hs, w["attn.wk"], precision).view(b, t, kh, dh)
        v = _mm(torch, hs, w["attn.wv"], precision).view(b, t, kh, dh)
        q, k = rope(torch, q, pos, theta), rope(torch, k, pos, theta)
        new_k.append(k)
        new_v.append(v)
        hk, hv = history_fn(i)
        a = attend(torch, q, hk, hv, k, v, precision)
        del hk, hv
        x = x + _mm(torch, a, w["attn.wo"], precision)
        hs = rmsnorm(torch, x, w["ln2"], eps)
        gate = _mm(torch, hs, w["mlp.w_gate"], precision)
        up = _mm(torch, hs, w["mlp.w_up"], precision)
        x = x + _mm(torch, torch.nn.functional.silu(gate) * up,
                    w["mlp.w_down"], precision)
        del w, gate, up, hs, q, a
    return rmsnorm(torch, x, outer["final_norm"], eps), new_k, new_v


def logits(torch, hidden, head, precision: str = "float32"):
    """The LM head: ``hidden @ head`` (float32)."""
    no_tf32(torch)
    return _mm(torch, hidden, head, precision)
