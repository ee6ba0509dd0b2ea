"""Mamba2 (SSD, state-space duality) layer: chunked prefill, recurrent decode.

The chunked SSD algorithm (Dao & Gu 2024, §6) splits the sequence into
chunks: the terms inside a chunk are dense matmuls, the terms between
chunks a short loop over per-chunk states.  Decode keeps the recurrent
state (B, H, P, N) plus the causal conv's tail of K - 1 inputs; one
token costs O(d_inner * N), a memory-bound step.

The reference's functions over parameter pytrees, over the port's
modules instead (``lm.Block``).  The reference computes all of it
outside any Pallas kernel (einsums, cumsums, elementwise), so it stays
plain PyTorch here.  Its three-operand einsums are written as explicit
products and batched matmuls, so no contraction order can build a
(B, nc, Q, H, P, N) intermediate; its ``lax.scan`` over chunks is a
Python loop.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init, rmsnorm

__all__ = ["init_ssm", "make_ssm_state", "ssm_layer"]


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device="cuda"
             ) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights, the reference's names and distributions.

    Projections kept separate (z / x / BC / dt), each ``(d_in, d_out)``;
    conv weights N(0, 0.01) over ``(K, C)`` with zero biases; ``a_log``
    log(linspace(1, 16)), ``dt_bias`` the inverse softplus of a
    log-uniform dt in [1e-3, 1e-1], unit ``d_skip`` and ``norm``.
    """
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, g, k = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_conv

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)
    u = torch.rand((h,), generator=gen, device=device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * u)
    return {
        "w_z": dense_init(gen, d, di, device=device),
        "w_x": dense_init(gen, d, di, device=device),
        "w_bc": dense_init(gen, d, 2 * g * n, device=device),
        "w_dt": dense_init(gen, d, h, device=device),
        "conv_x": normal(k, di).mul_(0.1),
        "conv_x_b": torch.zeros(di, device=device),
        "conv_bc": normal(k, 2 * g * n).mul_(0.1),
        "conv_bc_b": torch.zeros(2 * g * n, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "dt_bias": torch.log(torch.expm1(dt)),
        "d_skip": torch.ones(h, device=device),
        "norm": torch.ones(di, device=device),
        "out_proj": dense_init(gen, di, d, device=device),
    }


def _split_proj(p, u: torch.Tensor):
    """z, x, BC and dt projections of ``u`` (weights in u's dtype)."""
    return u @ p.w_z, u @ p.w_x, u @ p.w_bc, u @ p.w_dt


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, conv_state=None):
    """Depthwise causal conv of width K over (B, S, C).

    ``conv_state``: the (B, K-1, C) tail of the inputs before ``xbc``
    (zeros when None).  Returns (silu(conv + bias), the new tail).  The K
    products are summed left to right in the input's dtype, as the
    reference's Python ``sum``.
    """
    k = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s] * conv_w[i].to(xbc.dtype) for i in range(k))
    new_state = xp[:, -(k - 1):]
    return F.silu(out + conv_b.to(xbc.dtype)), new_state


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """Groups to heads along dim 3 (each group ``rep`` times in a row,
    as ``jnp.repeat``)."""
    return t.repeat_interleave(rep, dim=3)


def _ssd_chunked(x, dt, a, b, c, chunk: int):
    """Chunked SSD scan.

    x: (B,S,H,P), dt: (B,S,H), a: (H,) (positive decay rate),
    b, c: (B,S,G,N).  Returns y: (B,S,H,P), final_state: (B,H,P,N).
    """
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g

    def r(t):  # reshape into chunks
        return t.reshape(bs, nc, chunk, *t.shape[2:])

    xc, dtc, bc_, cc = r(x), r(dt), r(b), r(c)
    da = dtc * a                                            # (B,nc,Q,H)
    cum = torch.cumsum(da, dim=2)                           # within-chunk
    total = cum[:, :, -1]                                   # (B,nc,H)

    # intra-chunk (diagonal block): L[q,t] = exp(cum[q]-cum[t]) for q>=t;
    # the upper triangle is masked before the exp, where -seg > 0 could
    # overflow to inf
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,H)
    qi = torch.arange(chunk, device=x.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    l_mat = torch.exp(torch.where(causal, -seg, -math.inf))  # decay q<-t
    del seg
    # cb[q,t,g] = c_q . b_t
    cb = (cc.permute(0, 1, 3, 2, 4) @ bc_.permute(0, 1, 3, 4, 2)
          ).permute(0, 1, 3, 4, 2)                          # (B,nc,Q,Q,G)
    cb = cb.repeat_interleave(rep, dim=-1)                  # (B,nc,Q,Q,H)
    att = cb * l_mat * dtc[:, :, None, :, :]                # weight dt at t
    del cb, l_mat
    y_diag = (att.permute(0, 1, 4, 2, 3) @ xc.permute(0, 1, 3, 2, 4)
              ).permute(0, 1, 3, 2, 4)                      # (B,nc,Q,H,P)
    del att

    # per-chunk input states: sum_t exp(-(total - cum[t])) dt_t b_t x_t
    decay_in = torch.exp(cum - total[:, :, None])           # (B,nc,Q,H)
    wx = (xc * (dtc * decay_in)[..., None]).permute(0, 1, 3, 4, 2)
    if g == 1:                                              # (B,nc,H,P,Q)
        bx = (wx.reshape(bs, nc, h * p, chunk) @ bc_[:, :, :, 0]
              ).reshape(bs, nc, h, p, n)
    else:
        bx = wx @ _heads(bc_, rep).permute(0, 1, 3, 2, 4)   # (B,nc,H,P,N)
    del wx

    # inter-chunk recurrence over states, each chunk's state *before* it
    state = x.new_zeros((bs, h, p, n))
    decay = torch.exp(-total)[..., None, None]              # (B,nc,H,1,1)
    prev = []
    for z in range(nc):
        prev.append(state)
        state = state * decay[:, z] + bx[:, z]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    # inter-chunk output: y_off[q] = c_q . (decay to q) state_prev
    decay_out = torch.exp(-cum)                             # (B,nc,Q,H)
    if g == 1:
        y_off = (cc[:, :, :, 0] @ prev_states.reshape(bs, nc, h * p, n)
                 .transpose(-1, -2)).reshape(bs, nc, chunk, h, p)
    else:
        y_off = (_heads(cc, rep).permute(0, 1, 3, 2, 4)
                 @ prev_states.transpose(-1, -2)).permute(0, 1, 3, 2, 4)
    y_off = y_off * decay_out[..., None]
    y = (y_diag + y_off).reshape(bs, s, h, p)
    return y, state


def ssm_layer(p, x: torch.Tensor, cfg: ModelConfig, *,
              state: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mamba2 block.  state=None -> chunked scan over the full sequence;
    state given -> single-token recurrent update (decode).

    Returns (output, new state); ``state`` itself is left as it was.
    """
    dtype = x.dtype
    di, n, h, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_ngroups
    ph = cfg.ssm_headdim
    bsz, s, _ = x.shape

    z, xr, bcr, dt = _split_proj(p, x)
    dt = F.softplus(dt.float() + p.dt_bias)                 # (B,S,H)
    a = torch.exp(p.a_log)                                  # (H,) > 0

    cx = state["conv_x"] if state is not None else None
    cbc = state["conv_bc"] if state is not None else None
    x_c, tail_x = _causal_conv(xr, p.conv_x, p.conv_x_b, cx)
    bc_c, tail_bc = _causal_conv(bcr, p.conv_bc, p.conv_bc_b, cbc)
    xin = x_c.reshape(bsz, s, h, ph)
    bmat = bc_c[..., :g * n].reshape(bsz, s, g, n)
    cmat = bc_c[..., g * n:].reshape(bsz, s, g, n)

    if state is None:
        y, st = _ssd_chunked(xin.float(), dt, a, bmat.float(), cmat.float(),
                             min(cfg.ssm_chunk, s))
    else:
        # recurrent: state' = state * exp(-dt a) + dt * b x^T ; y = c . state'
        # (b and c summed over groups, as the reference's einsums)
        dt1 = dt[:, 0]                                      # (B,H)
        decay = torch.exp(-dt1 * a)[..., None, None]        # (B,H,1,1)
        bsum = bmat[:, 0].float().sum(dim=1)                # (B,N)
        csum = cmat[:, 0].float().sum(dim=1)
        bx = (xin[:, 0].float() * dt1[..., None])[..., None] * \
            bsum[:, None, None, :]                          # (B,H,P,N)
        st = state["ssm"] * decay + bx
        y = (st @ csum[:, None, :, None])[..., 0][:, None]  # (B,1,H,P)
    new_state = {"ssm": st, "conv_x": tail_x.float(),
                 "conv_bc": tail_bc.float()}

    y = y + xin.float() * p.d_skip[:, None]
    y = y.reshape(bsz, s, di).to(dtype)
    y = rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    return y @ p.out_proj, new_state


def make_ssm_state(cfg: ModelConfig, batch: int, device="cuda"
                   ) -> Dict[str, torch.Tensor]:
    """Zero decode state of one layer, float32: the (B, H, P, N) SSM state
    and the (B, K-1, C) conv tails of x and of BC."""
    return {
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                            cfg.ssm_state), device=device),
        "conv_x": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                              device=device),
        "conv_bc": torch.zeros((batch, cfg.ssm_conv - 1,
                                2 * cfg.ssm_ngroups * cfg.ssm_state),
                               device=device),
    }
