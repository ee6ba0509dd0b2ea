"""Flash-decode entry point: single-token GQA attention over a KV cache.

The LM-serving op the paper's framework classifies: GEMV-shaped and
memory-bound (I ~ 2G/D flop/byte against a machine balance in the
hundreds).  The only lever is streaming the cache once.  On the card
both engines are hand-written kernels in ``csrc/attention.cu``: the
vector kernel on the CUDA cores (FFMA and warp shuffles), the matrix
kernel on the tensor cores (float32: q.K^T and p.V in DMMA; bfloat16: both
in HMMA, p split into two bfloat16 terms for p.V).  Both read only the
cache positions below kv_len (all of them for kv_len <= 0).  ``flash_decode_plain`` repeats the reference
kernel's arithmetic in PyTorch: one online-softmax pass over KV blocks
of ``block_s`` positions.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.dispatch import check_backend
from .ref import NEG_INF

__all__ = ["flash_decode", "flash_decode_plain"]


def _scale(dh: int) -> torch.Tensor:
    """1 / sqrt(Dh), in float32 as the reference rounds it."""
    return torch.tensor(1.0) / torch.sqrt(torch.tensor(float(dh)))


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: int, *, block_s: int = 512,
                       engine: str = "matrix") -> torch.Tensor:
    """Plain PyTorch version of the flash-decode kernels.

    The reference kernel's steps over KV blocks of ``block_s`` positions:
    scores in float32, positions >= ``kv_len`` masked to -1e30, a running
    (m, l, acc) online softmax, ``acc / max(l, 1e-30)`` cast to q's dtype.
    The matrix engine's dots are taken in float64 and rounded to float32,
    as the DMMA kernel takes them; the vector engine's are float32 sums.
    """
    b, kh, g, dh = q.shape
    s = k.shape[1]
    if s % block_s:
        raise ValueError(f"block_s={block_s} must divide S={s}")
    dev = q.device
    qf = q.reshape(b * kh, g, dh).float()
    kf = k.movedim(2, 1).reshape(b * kh, s, dh).float()
    vf = v.movedim(2, 1).reshape(b * kh, s, dh).float()
    scale = _scale(dh).to(dev)
    m = torch.full((b * kh, g, 1), NEG_INF, device=dev)
    length = torch.zeros((b * kh, g, 1), device=dev)
    acc = torch.zeros((b * kh, g, dh), device=dev)
    for j in range(s // block_s):
        kb = kf[:, j * block_s:(j + 1) * block_s]
        vb = vf[:, j * block_s:(j + 1) * block_s]
        if engine == "matrix":
            sc = (qf.double() @ kb.double().transpose(1, 2)).float() * scale
        else:
            sc = (qf[:, :, None, :] * kb[:, None, :, :]).sum(-1) * scale
        pos = j * block_s + torch.arange(block_s, device=dev)
        sc = torch.where(pos < kv_len, sc, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        length = length * corr + p.sum(-1, keepdim=True)
        if engine == "matrix":
            pv = (p.double() @ vb.double()).float()
        else:
            pv = (p[:, :, :, None] * vb[:, None, :, :]).sum(2)
        acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp_min(length, 1e-30)
    return out.reshape(b, kh, g, dh).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: int, *, block_s: int = 512, engine: str = "matrix",
                 backend: str = "cuda",
                 split_pairs: Optional[int] = None) -> torch.Tensor:
    """q: (B, KH, G, Dh); k,v: (B, S, KH, Dh); kv_len a Python int.

    ``engine`` picks the kernel: 'matrix' runs the score and p.V
    contractions on the tensor cores, 'vector' on the CUDA cores.
    Either way the cache is streamed exactly once.  ``backend="cuda"``
    launches the kernel and needs tensors on the card; ``"plain"`` runs
    ``flash_decode_plain`` on CPU tensors.  ``kv_len`` is a host int, so
    a decode loop never waits on the card for it.  ``split_pairs`` is the
    ``B * KH`` whose split-S schedule the kernel runs (default this
    call's; a head shard of ``repro_torch.sharding`` passes the unsharded
    call's); the plain version's block loop has no such schedule.

    Returns (B, KH, G, Dh) in q's dtype."""
    s = k.shape[1]
    if s % block_s:
        raise ValueError(f"block_s={block_s} must divide S={s}")
    check_backend(backend, q, k, v)
    if backend == "plain":
        return flash_decode_plain(q, k, v, kv_len, block_s=block_s,
                                  engine=engine)
    from .. import _ext
    return _ext.attention(q.contiguous(), k, v, int(kv_len), block_s=block_s,
                          engine=engine, split_pairs=split_pairs)
