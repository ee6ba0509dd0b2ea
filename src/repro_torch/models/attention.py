"""Attention: GQA with chunked (flash-style) softmax, KV caches, MLA.

Grouped-query attention never materializes repeated KV heads: scores are
computed with the (kv_head, group) factorization, query head
``kv_head * G + g``.  Long prompts go through a chunked online-softmax
loop (q-chunks outer, kv-chunks inner) so memory stays tile-sized.

Single-token decode goes through the registered flash-decode op when
``cfg.decode_attention_impl == "registry"``: the hand-written kernel on
the card, its plain version on the CPU.  The KV cache is updated in
place (``cache["k"][:, idx] = k``), where the reference builds a new one
with ``dynamic_update_slice``.

MLA (DeepSeek-V2) caches the compressed latent and the shared rope key;
prefill decompresses them through ``wkv_b``, and decode runs the
*absorbed* formulation (``w_uk`` folded into q, scores against the
latent, ``w_uv`` applied after the weighted latent sum), the cache never
decompressed.  MLA decode runs no flash-decode kernel, as in the
reference; its scores, softmax and weighted latent sum are batched
products over the valid cache positions only (``latent_decode``).

Cross-attention (the encoder-decoder family) projects the encoder's
output to K / V once (``make_cross_kv``, cached across decode steps as
``ck`` / ``cv``) and attends to every encoder position with the plain
dense softmax, no RoPE and no causal mask (``cross_attend``): the
reference runs it outside any Pallas kernel, and so it runs no
flash-decode kernel here either.

The int8 KV cache (``make_cache(dtype=torch.int8)``) holds k and v as
int8 with one float32 scale per (position, KV head), ``max|x| / 127``
floored at 1e-8; a decode step quantizes its new rows into it
(``_int8_cache_update``) and dequantizes the whole cache into the compute
dtype before the flash-decode kernel or the dense path reads it, as the
reference does.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..obs.trace import TRACER
from .config import ModelConfig, YarnRopeConfig, yarn_mscale
from .layers import (apply_mrope, apply_rope, apply_rope_freqs,
                     pairs_to_halves, rmsnorm, yarn_frequencies)

__all__ = ["attention", "cross_attend", "make_cache", "make_cross_kv",
           "mla_attention", "sdpa"]

NEG_INF = -1e30


# --------------------------------------------------------------------------
# core attention math
# --------------------------------------------------------------------------

def _scale(dh: int, device) -> torch.Tensor:
    return (torch.tensor(1.0) / torch.sqrt(torch.tensor(float(dh)))).to(device)


def _gqa_scores(q, k):
    """q: (B,Sq,KH,G,Dh), k: (B,Skv,KH,Dh) -> (B,KH,G,Sq,Skv)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q, k)


def _gqa_out(w, v):
    """w: (B,KH,G,Sq,Skv), v: (B,Skv,KH,Dh) -> (B,Sq,KH,G,Dh)."""
    return torch.einsum("bhgqk,bkhd->bqhgd", w, v)


def _sdpa_dense(q, k, v, q_pos, kv_pos, causal: bool, kv_len=None):
    """Unchunked softmax attention with GQA factorization.

    q: (B,Sq,KH,G,Dh); k,v: (B,Skv,KH,Dh); positions broadcast (B,S)."""
    s = _gqa_scores(q, k).float() * _scale(q.shape[-1], q.device)
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        mask = kv_pos[:, None, :] <= q_pos[:, :, None]       # (B,Sq,Skv)
        mask = mask[:, None, None]
    if kv_len is not None:
        valid = (torch.arange(k.shape[1], device=k.device)[None, :]
                 < kv_len[:, None])
        mask = mask & valid[:, None, None, None, :]
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_out(w, v)


def _sdpa_flash(q, k, v, q_pos, kv_pos, causal: bool, q_chunk: int,
                kv_chunk: int):
    """Chunked online-softmax attention (memory = tiles)."""
    b, sq, kh, g, dh = q.shape
    skv = k.shape[1]
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"chunks {q_chunk}/{kv_chunk} must divide "
                         f"{sq}/{skv}")
    scale = _scale(dh, q.device)
    # the chunks are split once: views, whose gradients one cat gathers
    ks, vs = k.split(kv_chunk, dim=1), v.split(kv_chunk, dim=1)
    kps = kv_pos.split(kv_chunk, dim=1)
    outs = []
    for qi, qpi in zip(q.split(q_chunk, dim=1), q_pos.split(q_chunk, dim=1)):
        acc = torch.zeros((b, kh, g, q_chunk, dh), device=q.device)
        m = torch.full((b, kh, g, q_chunk), NEG_INF, device=q.device)
        length = torch.zeros((b, kh, g, q_chunk), device=q.device)
        for ki, vi, kpi in zip(ks, vs, kps):
            s = _gqa_scores(qi, ki).float() * scale
            if causal:
                mask = kpi[:, None, :] <= qpi[:, :, None]
                s = torch.where(mask[:, None, None], s,
                                torch.tensor(NEG_INF, device=s.device))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            length = length * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _gqa_out(
                p.to(qi.dtype), vi).float().permute(0, 2, 3, 1, 4)
            m = m_new
        out = (acc / torch.clamp_min(length, 1e-30)[..., None]).permute(
            0, 3, 1, 2, 4)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def sdpa(q, k, v, q_pos, kv_pos, *, causal: bool, kv_len=None,
         q_chunk: int = 512, kv_chunk: int = 1024):
    """Dispatch dense vs flash by size; shapes as in ``_sdpa_dense``."""
    sq, skv = q.shape[1], k.shape[1]
    if (sq > q_chunk and sq % q_chunk == 0 and skv % kv_chunk == 0
            and kv_len is None):
        return _sdpa_flash(q, k, v, q_pos, kv_pos, causal, q_chunk, kv_chunk)
    return _sdpa_dense(q, k, v, q_pos, kv_pos, causal, kv_len)


# --------------------------------------------------------------------------
# GQA attention layer
# --------------------------------------------------------------------------

def _project_qkv(p, x, kv_x, cfg: ModelConfig):
    q = x @ p.wq
    k = kv_x @ p.wk
    v = kv_x @ p.wv
    if "bq" in p:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    b, sq = x.shape[:2]
    skv = kv_x.shape[1]
    q = q.reshape(b, sq, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, skv, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, skv, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _rope_qk(q, k, q_pos, kv_pos, cfg: ModelConfig):
    if cfg.rope_kind == "none":
        return q, k
    if cfg.rope_kind == "mrope":
        return (apply_mrope(q, q_pos, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, kv_pos, cfg.rope_theta, cfg.mrope_sections))
    return (apply_rope(q, q_pos, cfg.rope_theta),
            apply_rope(k, kv_pos, cfg.rope_theta))


def _scalar_pos(positions, cfg: ModelConfig):
    """The (B,S) stream used for causal masking (mrope uses temporal)."""
    return positions[0] if cfg.rope_kind == "mrope" else positions


def attention(p, x, cfg: ModelConfig, *, positions,
              cache: Optional[Dict] = None, cache_index: Optional[int] = None,
              kv_x=None, kv_positions=None, causal: bool = True
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Attention in train/prefill and decode mode.

    train/prefill: cache=None -> full self-attention; returns the fresh
      cache ``{"k", "v"}``.
    decode: cache given + cache_index (a Python int) -> one-step attention
      against the cache, which is updated in place and returned.
    cross: kv_x given -> encoder-decoder attention (no causal mask);
      returns the encoder's K / V as ``{"ck", "cv"}``.
    """
    if cfg.use_mla and kv_x is None:
        return mla_attention(p, x, cfg, positions=positions, cache=cache,
                             cache_index=cache_index)
    if kv_x is not None:                                     # cross-attention
        k, v = make_cross_kv(p, kv_x, cfg)
        out = cross_attend(p, x, cfg, (k, v), _scalar_pos(positions, cfg),
                           kv_positions)
        return out, {"ck": k, "cv": v}
    b, sq, _ = x.shape
    group = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(p, x, x, cfg)
    q, k = _rope_qk(q, k, positions, positions, cfg)
    if cache is None:                                        # train / prefill
        new_cache = {"k": k, "v": v}
        q = q.reshape(b, sq, cfg.n_kv_heads, group, cfg.head_dim)
        qpos = _scalar_pos(positions, cfg)
        out = sdpa(q, k, v, qpos, qpos, causal=causal)
        out = out.reshape(b, sq, cfg.n_heads * cfg.head_dim)
        return out @ p.wo, new_cache
    out = _attend_cache(q, k, v, cache, cache_index, cfg, positions)
    out = out.reshape(b, sq, cfg.n_heads * cfg.head_dim)
    return out @ p.wo, cache


def _attend_cache(q, k, v, cache: Dict, cache_index: int, cfg: ModelConfig,
                  positions) -> torch.Tensor:
    """A decode step's attention against its KV cache: the step's ``k`` /
    ``v`` rows (B, Sq, KH, Dh) written into ``cache`` in place at
    ``cache_index`` (quantized where the cache is int8), then ``q`` (B,
    Sq, H, Dh) against every valid position of the cache in q's dtype.
    Returns (B, Sq, KH, G, Dh)."""
    b, sq = q.shape[:2]
    group = cfg.n_heads // cfg.n_kv_heads
    if cache["k"].dtype == torch.int8:
        _int8_cache_update(cache, k, v, cache_index)
        # int8 -> q.dtype is exact, so the promoting multiply rounds as
        # the reference's cast-then-multiply does, in one pass
        ck = cache["k"] * cache["k_scale"][..., None].to(q.dtype)
        cv = cache["v"] * cache["v_scale"][..., None].to(q.dtype)
    else:
        cache["k"][:, cache_index:cache_index + sq] = k.to(cache["k"].dtype)
        cache["v"][:, cache_index:cache_index + sq] = v.to(cache["v"].dtype)
        ck = cache["k"].to(q.dtype)
        cv = cache["v"].to(q.dtype)
    q = q.reshape(b, sq, cfg.n_kv_heads, group, cfg.head_dim)
    if cfg.decode_attention_impl == "registry" and sq == 1:
        # single-token decode through the registered flash-decode op:
        # the dispatcher's memoized Advice routes engine='auto' (vector on
        # this memory-bound shape); the kernel on the card, its plain
        # version on the CPU
        from ..kernels.attention.ops import decode_attention
        out = decode_attention(q[:, 0], ck, cv, cache_index + sq,
                               engine=cfg.decode_attention_engine,
                               backend="cuda" if q.is_cuda else "plain")
        return out[:, None]
    kv_len = torch.full((b,), cache_index + sq, dtype=torch.int32,
                        device=q.device)
    kv_pos = torch.arange(ck.shape[1], device=q.device)[None].expand(
        b, ck.shape[1])
    return _sdpa_dense(q, ck, cv, _scalar_pos(positions, cfg), kv_pos,
                       causal=True, kv_len=kv_len)


def make_cross_kv(p, enc_out, cfg: ModelConfig):
    """Project the encoder's output to K / V once (cached across decode
    steps): two ``(B, Se, KH, Dh)`` tensors."""
    b, se, _ = enc_out.shape
    k = enc_out @ p.wk
    v = enc_out @ p.wv
    if "bk" in p:
        k = k + p.bk
        v = v + p.bv
    return (k.reshape(b, se, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, se, cfg.n_kv_heads, cfg.head_dim))


def cross_attend(p, x, cfg: ModelConfig, kv, q_pos, kv_pos):
    """Attention of ``x`` to every position of the encoder's ``kv``: the
    q projection (with its bias), the dense softmax unmasked, ``wo``."""
    dtype = x.dtype
    b, sq, _ = x.shape
    group = cfg.n_heads // cfg.n_kv_heads
    q = x @ p.wq
    if "bq" in p:
        q = q + p.bq
    q = q.reshape(b, sq, cfg.n_kv_heads, group, cfg.head_dim)
    k, v = kv
    out = _sdpa_dense(q, k.to(dtype), v.to(dtype), q_pos, kv_pos,
                      causal=False)
    out = out.reshape(b, sq, cfg.n_heads * cfg.head_dim)
    return out @ p.wo


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict:
    """Zero caches for one layer: ``(B, max_len, KH, Dh)`` k and v, or
    MLA's ``(B, max_len, kv_lora_rank)`` latent and ``(B, max_len,
    qk_rope_dim)`` rope key (bfloat16 where an int8 cache is asked for,
    as the reference keeps them)."""
    if cfg.use_mla:
        lat = torch.bfloat16 if dtype == torch.int8 else dtype
        return {"latent": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                      dtype=lat, device=device),
                "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                      dtype=lat, device=device)}
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                  device=device)
    return c


def _quantize_int8(x: torch.Tensor):
    """Rows of ``x`` (..., Dh) as int8 and their float32 scales (...):
    ``max|x| / 127`` floored at 1e-8, ``round(x / scale)`` (half to even,
    a true division as the reference's) clipped to +-127."""
    scale = torch.clamp_min(x.abs().amax(dim=-1) / 127.0, 1e-8)
    xq = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return xq.to(torch.int8), scale


def _int8_cache_update(cache: Dict, k, v, cache_index: int) -> Dict:
    """Quantize the new K / V rows (B, S, KH, Dh) with per-(position,
    head) scales and write them, and their scales, into the int8 ``cache``
    in place at ``cache_index``.  Returns ``cache``."""
    sq = k.shape[1]
    kq, ks = _quantize_int8(k.float())
    vq, vs = _quantize_int8(v.float())
    for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                      ("v_scale", vs)):
        cache[name][:, cache_index:cache_index + sq] = val
    return cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# --------------------------------------------------------------------------

def _mla_q(p, x, cfg: ModelConfig):
    if cfg.q_lora_rank:
        q = rmsnorm(p.q_norm, x @ p.wq_a, cfg.norm_eps) @ p.wq_b
    else:
        q = x @ p.wq
    b, s = x.shape[:2]
    q = q.reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]


@functools.lru_cache(maxsize=None)
def _yarn(cfg: YarnRopeConfig, device: str) -> Tuple[torch.Tensor, float]:
    """(inverse frequencies, cos / sin factor) of a YaRN config's rotary
    dims on ``device``, made once."""
    freqs = yarn_frequencies(cfg.qk_rope_dim, cfg.rope_theta,
                             cfg.yarn_factor, cfg.yarn_original_len,
                             cfg.yarn_beta_fast, cfg.yarn_beta_slow, device)
    mscale = (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
              / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
    return freqs, mscale


def _yarn_on(cfg: ModelConfig) -> bool:
    return isinstance(cfg, YarnRopeConfig) and cfg.yarn_factor > 1


def _mla_rope(x, positions, cfg: ModelConfig):
    """MLA's rotary embedding of q_pe / k_pe (B, S, heads, rd): rotate-half
    with the plain frequencies of ``rope_theta``, or YaRN's for a
    :class:`YarnRopeConfig` with a factor above 1; its (even, odd) pairs
    first reordered to halves where it sets ``rope_pairs``."""
    if isinstance(cfg, YarnRopeConfig) and cfg.rope_pairs:
        x = pairs_to_halves(x)
    if not _yarn_on(cfg):
        return apply_rope(x, positions, cfg.rope_theta)
    freqs, mscale = _yarn(cfg, str(x.device))
    return apply_rope_freqs(x, positions, freqs, mscale)


def latent_decode(q_lat: torch.Tensor, q_rope: torch.Tensor,
                  latent: torch.Tensor, k_rope: torch.Tensor, kv_len: int,
                  scale: float) -> torch.Tensor:
    """out_lat (B, s, H, r): ``softmax((q_lat . latent + q_rope . k_rope)
    * scale) . latent`` over positions ``[0, kv_len)`` of the caches
    ``latent`` (B, S_max, r) and ``k_rope`` (B, S_max, rd), for q_lat
    (B, s, H, r) and q_rope (B, s, H, rd).  Every query row of a sequence
    sees the same positions, so the s x H rows are one batched product's
    rows, and positions at or past ``kv_len`` are never read: no mask.
    The softmax runs in float32, the weighted sum in ``q_lat``'s dtype."""
    b, s, h, r = q_lat.shape
    dtype = q_lat.dtype
    q, q_r = q_lat.reshape(b, s * h, r), q_rope.reshape(b, s * h, -1)
    lat = latent[:, :kv_len].to(dtype)
    kr = k_rope[:, :kv_len].to(dtype).transpose(1, 2)
    if dtype == torch.float32:
        # the latent scores added onto the rope scores with the scale by
        # one product, in place: the scaled sum rounded once, within
        # float32's rounding of (a + b) * scale, and no pass over scores
        sc = torch.bmm(q_r, kr).baddbmm_(q, lat.transpose(1, 2),
                                         beta=scale, alpha=scale)
    else:
        # a narrower type rounds each product, then their sum, before the
        # float32 scale, as the reference does
        sc = (torch.bmm(q, lat.transpose(1, 2)) + torch.bmm(q_r, kr)
              ).float() * scale
    w = torch.softmax(sc.float(), dim=-1).to(dtype)
    return torch.bmm(w, lat).reshape(b, s, h, r)


def mla_attention(p, x, cfg: ModelConfig, *, positions, cache=None,
                  cache_index: Optional[int] = None):
    """MLA: latent-compressed KV.  Prefill returns the fresh cache
    ``{"latent", "k_rope"}``; decode (cache given, ``cache_index`` a
    Python int) writes the step's rows into it in place and runs the
    absorbed formulation entirely in latent space, inside a
    ``model.mla`` span: the absorb, ``latent_decode`` over the valid
    positions, ``w_uv``."""
    dtype = x.dtype
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    kv_a = x @ p.wkv_a                                      # (B,S,r+rd)
    latent = rmsnorm(p.kv_norm, kv_a[..., :r], cfg.norm_eps)
    k_rope = _mla_rope(kv_a[..., r:].reshape(b, s, 1, rd), positions, cfg)
    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = _mla_rope(q_rope, positions, cfg)
    # the float32 1 / sqrt(nope + rd) as a Python number: a 0-d tensor
    # made on the host and moved to the card would make the host wait for
    # the card in every layer
    scale = (cfg.mla_softmax_scale if _yarn_on(cfg)
             else float(_scale(nope + rd, "cpu")))

    if cache is None:                                        # train / prefill
        kv = (latent @ p.wkv_b).reshape(b, s, h, nope + vd)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        sc = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkod->bhqk", q_rope, k_rope)
              ).float() * scale
        mask = positions[:, None, :] <= positions[:, :, None]
        sc = torch.where(mask[:, None], sc, NEG_INF)
        w = torch.softmax(sc, dim=-1).to(dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, h * vd)
        return out @ p.wo, {"latent": latent, "k_rope": k_rope.squeeze(2)}

    # decode: the absorbed path, the cache written in place
    lat, kr = cache["latent"], cache["k_rope"]
    lat[:, cache_index:cache_index + s] = latent.to(lat.dtype)
    kr[:, cache_index:cache_index + s] = k_rope.squeeze(2).to(kr.dtype)
    with TRACER.span("model.mla", layer="model"):
        wkv_b = p.wkv_b.reshape(r, h, nope + vd)
        w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
        # absorb: q' = q_nope @ w_uk -> score against the latent directly
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)  # (B,s,H,r)
        out_lat = latent_decode(q_lat, q_rope, lat, kr, cache_index + s,
                                scale)                        # (B,s,H,r)
        out = torch.einsum("bqhr,rhd->bqhd", out_lat, w_uv)   # (B,s,H,vd)
    return out.reshape(b, s, h * vd) @ p.wo, cache
