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
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init

__all__ = ["Routed", "combine", "dispatch", "expert_ffn", "init_moe",
           "moe_ffn", "top_k"]


def init_moe(gen: torch.Generator, cfg: ModelConfig, device="cuda"
             ) -> Dict[str, torch.Tensor]:
    """Seeded float32 router, expert and shared-expert weights.

    The reference's distributions: router N(0, 0.02^2), expert weights
    N(0, 1/d_in), ``(E, d_in, d_out)``; shared experts as dense layers of
    ``n_shared_experts * moe_d_ff``.
    """
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

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
    """
    r = dispatch(p, x, cfg, group_size)
    return combine(p, r, expert_ffn(p, r.xe), cfg, x.shape)
