"""Mixture-of-Experts FFN: top-k router + capacity-based grouped dispatch.

The reference's GShard / Switch formulation, kept exactly: tokens are
routed within groups of ``group_size``, every expert has a per-group
buffer of ``capacity`` slots, a token's slot in its expert's buffer is
its rank in the token-major, slot-minor order, and slots past the
capacity are dropped (on a full expert the *last* tokens lose).  Router
z-loss and the load-balancing aux loss are returned beside the output.

Where the reference builds one-hot combine / dispatch tensors
``(G, Sg, E, C)`` and contracts them with einsums, the port scatters
each kept token into its ``(E, C, D)`` buffer slot by index and gathers
its experts' outputs back the same way: the same per-token sums, without
the one-hot tensors.  Every expert's product runs for every step, one
batched matmul per projection over all experts' buffers, as the
reference's einsums do; computing only the experts a step touches is a
later lever (ROADMAP.md Queue 1 item 10).

An :class:`~.config.ExpertShareConfig` (DeepSeek-V2's) takes the expert
share instead (``share_ffn``): the layer holds ``n_experts`` of the
gate's ``router_experts``, routes every token over all of them with a
group-limited gate (``route``; DeepSeek-V2's published one), and computes
its held experts' part, dropless, each held expert over the rows routed to it and no other
(``kernels.experts.grouped_swiglu``), plus the shared experts.  What the
experts held elsewhere would add is left out.  The rows are sorted by
held expert on the card and the kernel reads their counts there, so the
host never waits for the card.  While ``obs.record.RECORD`` records, each
call leaves the rows routed to each held expert (``moe.counts``), each
token's experts (``moe.routes``) and their weights (``moe.gates``).
Spans: ``model.moe.route``, ``model.moe.experts`` (the kernel inside its
``launch.experts``) and ``model.moe.shared``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.experts import grouped_swiglu
from ..obs.record import RECORD
from ..obs.trace import TRACER
from .config import ExpertShareConfig, ModelConfig
from .layers import dense_init

__all__ = ["Routed", "combine", "dispatch", "expert_ffn", "init_moe",
           "moe_ffn", "route", "share_ffn", "top_k"]


def init_moe(gen: torch.Generator, cfg: ModelConfig, device="cuda"
             ) -> Dict[str, torch.Tensor]:
    """Seeded float32 router, expert and shared-expert weights.

    The reference's distributions: router N(0, 0.02^2), expert weights
    N(0, 1/d_in), ``(E, d_in, d_out)``; shared experts as dense layers of
    ``n_shared_experts * moe_d_ff``.
    """
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    if isinstance(cfg, ExpertShareConfig):
        return _init_share(gen, cfg, device)

    def experts(d_in, d_out):
        w = torch.randn((e, d_in, d_out), generator=gen, device=device)
        return w.div_(d_in ** 0.5)
    t = {"router": dense_init(gen, d, e, scale=0.02, device=device),
         "w_gate": experts(d, f), "w_up": experts(d, f),
         "w_down": experts(f, d)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.moe_d_ff
        t["shared.w_gate"] = dense_init(gen, d, fs, device=device)
        t["shared.w_up"] = dense_init(gen, d, fs, device=device)
        t["shared.w_down"] = dense_init(gen, fs, d, device=device)
    return t


def _init_share(gen: Optional[torch.Generator], cfg: ExpertShareConfig,
                device) -> Dict[str, torch.Tensor]:
    """An expert share's weights: the router over all ``router_experts``
    and the shared experts from ``gen``, and each held expert from a
    generator of its own, seeded by one draw of ``gen`` (the layer's) and
    the expert's id, so that a share holds the same weights for an
    expert whichever others it holds."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    t = {"router": dense_init(gen, d, cfg.router_experts, scale=0.02,
                              device=device)}
    layer = (0 if gen is None else
             int(torch.randint(2**40, (1,), generator=gen, device=device)))
    for name, d_in, d_out in (("w_gate", d, f), ("w_up", d, f),
                              ("w_down", f, d)):
        t[name] = torch.empty((e, d_in, d_out), device=device)
    for j in range(e):
        g = (None if gen is None else torch.Generator(device=device)
             .manual_seed(layer * 4099 + cfg.expert_start + j))
        for name in ("w_gate", "w_up", "w_down"):
            w = t[name][j]
            w.copy_(torch.randn(w.shape, generator=g, device=device)
                    .div_(w.shape[0] ** 0.5))
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.moe_d_ff
        t["shared.w_gate"] = dense_init(gen, d, fs, device=device)
        t["shared.w_up"] = dense_init(gen, d, fs, device=device)
        t["shared.w_down"] = dense_init(gen, fs, d, device=device)
    return t


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cap, 4)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of the last axis and their indices, ties
    to the lower index first, as ``jax.lax.top_k`` orders them: a stable
    descending sort (``torch.topk`` gives no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routed(NamedTuple):
    """A batch routed to its experts (``dispatch``): the tokens ``xt``
    (G, Sg, D), the experts' buffers ``xe`` (G, E, C, D), each (token,
    slot)'s buffer row ``flat`` (G, Sg, k) and gate ``gates`` (0 where
    dropped), and what the aux losses read."""

    xt: torch.Tensor
    xe: torch.Tensor
    flat: torch.Tensor
    gates: torch.Tensor
    probs: torch.Tensor
    onehot: torch.Tensor
    logits: torch.Tensor


def dispatch(p, x: torch.Tensor, cfg: ModelConfig, group_size: int = 2048
             ) -> Routed:
    """Route x (B,S,D) with ``p.router`` and scatter each kept (token,
    slot) into its expert's buffer."""
    dtype = x.dtype
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    sg = min(group_size, t)
    while t % sg:                         # fall back to a divisor
        sg //= 2
    g = t // sg
    cap = _capacity(sg, cfg)
    xt = x.reshape(g, sg, d)

    logits = (xt @ p.router).float()                                # (G,Sg,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = top_k(probs, k)                                # (G,Sg,k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # position of each (token, slot) in its expert's per-group buffer:
    # a running count over the token-major, slot-minor flattening
    onehot = F.one_hot(idx, e)                                      # (G,Sg,k,E)
    slot_flat = onehot.reshape(g, sg * k, e)
    pos_flat = torch.cumsum(slot_flat, dim=1) - 1
    pos = (pos_flat * slot_flat).sum(-1).reshape(g, sg, k)
    keep = pos < cap
    gate_vals = gate_vals * keep.float()

    # dispatch: each kept (token, slot) into buffer row (group, expert,
    # pos); dropped slots into one spare row past the buffers, cut off
    # after (a boolean mask would make the host wait for the card)
    n = g * e * cap
    gi = torch.arange(g, device=x.device)[:, None, None]
    flat = (gi * e + idx) * cap + torch.clamp_max(pos, cap - 1)     # (G,Sg,k)
    xe = torch.zeros((n + 1, d), dtype=dtype, device=x.device)
    xe[torch.where(keep, flat, n).reshape(-1)] = \
        xt[:, :, None, :].expand(g, sg, k, d).reshape(-1, d)
    xe = xe[:n].reshape(g, e, cap, d)
    return Routed(xt, xe, flat, gate_vals, probs, onehot, logits)


def expert_ffn(p, xe: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its buffers: xe (G, E, C, D) with
    ``p.w_gate`` / ``w_up`` (E, D, F) and ``w_down`` (E, F, D)."""
    gt = torch.einsum("gecd,edf->gecf", xe, p.w_gate)
    u = torch.einsum("gecd,edf->gecf", xe, p.w_up)
    h = F.silu(gt) * u
    return torch.einsum("gecf,efd->gecd", h, p.w_down)


def combine(p, r: Routed, y: torch.Tensor, cfg: ModelConfig,
            shape) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The experts' outputs y (G, E, C, D) back to the tokens, the shared
    experts added: (output of ``shape``, aux metrics)."""
    g, sg, d = r.xt.shape
    e = cfg.n_experts
    # combine: each token's kept slots' outputs, weighed by their gates
    # (a dropped slot reads a clamped position and weighs it by 0)
    picked = y.reshape(-1, d)[r.flat]                               # (G,Sg,k,D)
    out = (picked * r.gates.to(y.dtype)[..., None]).sum(2)
    xt = r.xt.reshape(g * sg, d)
    out = out.reshape(g * sg, d)

    # aux losses (Switch-style load balance + router z-loss), taken
    # before the shared experts: a checkpoint's recompute stops at the
    # last tensor its backward saves, so it skips their down product, as
    # the reference's remat drops it
    me = r.probs.mean(dim=(0, 1))                                   # (E,)
    ce = r.onehot.float().sum(dim=2).mean(dim=(0, 1))               # (E,)
    aux = (me * ce).sum() * e * cfg.router_aux_weight
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2) * 1e-3

    if "shared" in p:
        sp = p.shared
        out = out + (F.silu(xt @ sp.w_gate) * (xt @ sp.w_up)) @ sp.w_down
    return out.reshape(shape), {"aux_loss": aux, "z_loss": z}


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, group_size: int = 2048
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,S,D) -> (B,S,D), aux metrics {aux_loss, z_loss}.

    ``p`` holds ``router`` (D, E), ``w_gate`` / ``w_up`` (E, D, F),
    ``w_down`` (E, F, D) and, with shared experts, a ``shared`` group of
    dense SwiGLU weights; all in x's dtype but the router's logits, which
    are taken in float32 after the product, as the reference takes them.
    An :class:`~.config.ExpertShareConfig` takes ``share_ffn`` (no aux
    metrics).
    """
    if isinstance(cfg, ExpertShareConfig):
        return share_ffn(p, x, cfg), {}
    r = dispatch(p, x, cfg, group_size)
    return combine(p, r, expert_ffn(p, r.xe), cfg, x.shape)


# --------------------------------------------------------------------------
# the expert share (ExpertShareConfig)
# --------------------------------------------------------------------------

def route(x: torch.Tensor, router: torch.Tensor, cfg: ExpertShareConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The group-limited greedy gate of tokens x (T, D) (DeepSeek-V2's
    published ``group_limited_greedy``): (T, top_k) expert ids over all
    ``router_experts`` and their weights.

    Softmax scores over every expert (float32); each of the ``n_groups``
    contiguous groups scored by its best expert; the ``topk_groups`` best
    groups kept and the other experts' scores set to 0; the ``top_k`` best
    experts of what is left, weighed by their scores times
    ``routed_scale`` (no renormalisation).  Ties go to the lower index, at
    both stages (``top_k``)."""
    scores = torch.softmax((x @ router).float(), dim=-1)            # (T,E)
    t, e = scores.shape
    g = cfg.n_groups
    groups = scores.view(t, g, e // g).amax(-1)                      # (T,G)
    _, gidx = top_k(groups, cfg.topk_groups)
    keep = torch.zeros((t, g), dtype=torch.bool, device=x.device)
    keep.scatter_(1, gidx, True)
    keep = keep[:, :, None].expand(t, g, e // g).reshape(t, e)
    w, idx = top_k(scores.masked_fill(~keep, 0.0), cfg.top_k)
    return idx, w * cfg.routed_scale


def _held_experts(p, x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                  cfg: ExpertShareConfig) -> torch.Tensor:
    """The held experts' part of the output of tokens x (T, D) routed to
    ``idx`` with weights ``w`` (T, k): the (token, slot) pairs sorted by
    held expert (the others last), each held expert's SwiGLU over its
    rows, the results weighed back onto their tokens."""
    t, k = idx.shape
    n = cfg.n_experts
    local = idx - cfg.expert_start
    held = (local >= 0) & (local < n)                                # (T,k)
    key = torch.where(held, local, n).reshape(-1)
    order = torch.argsort(key, stable=True)
    offsets = torch.searchsorted(
        key[order], torch.arange(n + 1, device=x.device, dtype=key.dtype)
    ).to(torch.int32)
    if RECORD.enabled:
        RECORD.add("moe.counts", offsets.diff())
        RECORD.add("moe.routes", idx)
        RECORD.add("moe.gates", w)
    xs = x[order // k]
    with TRACER.span("launch.experts", layer="kernels"):
        y = grouped_swiglu(xs, offsets, p.w_gate, p.w_up, p.w_down)
    # back to (token, slot) order; a slot of an expert held elsewhere
    # reads a row the kernel left unwritten, and weighs 0
    y = y[torch.argsort(order)].view(t, k, -1)
    y = torch.where(held[..., None], y, 0.0)
    return (y * w[..., None].to(y.dtype)).sum(1)


def share_ffn(p, x: torch.Tensor, cfg: ExpertShareConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): the expert share's part of an MoE layer
    (module docstring).  ``p`` holds ``router``
    (D, router_experts), the held experts' ``w_gate`` / ``w_up`` (n, D,
    F) and ``w_down`` (n, F, D), and the ``shared`` experts' SwiGLU."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    with TRACER.span("model.moe.route", layer="model"):
        idx, w = route(xt, p.router, cfg)
    with TRACER.span("model.moe.experts", layer="model"):
        out = _held_experts(p, xt, idx, w, cfg).to(x.dtype)
    if "shared" in p:
        with TRACER.span("model.moe.shared", layer="model"):
            sp = p.shared
            out = out + (F.silu(xt @ sp.w_gate) * (xt @ sp.w_up)) @ sp.w_down
    return out.reshape(shape)
