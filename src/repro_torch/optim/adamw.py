"""AdamW with decoupled weight decay, global-norm clipping, schedules.

The reference's optimizer over the port's parameter trees (``tree``: an
``lm.LM``, or dicts of tensors).  The state is the reference's: a count
and the parameter-shaped ``m`` and ``v`` (and float32 ``master`` weights
where the parameters live in a narrower dtype).  Its arithmetic is the
reference's, op for op, in float32 tensors: the schedule and the bias
corrections from the int32 count, each product and sum rounded where the
reference rounds it.  ``update`` writes the parameters and the state in
place, leaf by leaf, where the reference builds new trees: a full-width
model's state does not fit on the card twice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .tree import leaves, named_leaves, tree_map

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "global_norm"]


class AdamWState(NamedTuple):
    """The optimizer's state: an int32 0-d ``count`` and trees of the
    parameters' shape, float32."""

    count: torch.Tensor
    m: Any
    v: Any
    master: Optional[Any] = None  # float32 masters when params are narrower


def _decays(tree: Any) -> List[bool]:
    """Whether each leaf is decayed: the reference decays leaves of two
    dimensions or more *in its own layout*, where a layer group's leaves
    carry the stacked layer axes, so a layer's norm weight (L, D) is
    decayed and ``final_norm`` (D,) is not."""
    if isinstance(tree, nn.Module):
        from ..carry import stacked_axes
        axes = stacked_axes(tree.cfg)
        return [t.ndim + axes.get(n.split(".")[0], 0) >= 2
                for n, t in named_leaves(tree)]
    return [t.ndim >= 2 for t in leaves(tree)]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The reference's AdamW: bias-corrected moments, decoupled weight
    decay on matrices, clipping by the global norm, optional float32
    master weights."""

    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    master_weights: bool = False

    def init(self, params: Any) -> AdamWState:
        """Zero moments (and float32 copies of ``params`` as masters)."""
        def zeros(t):
            return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        first = leaves(params)[0]
        master = (tree_map(lambda t: t.detach().float().clone(), params)
                  if self.master_weights else None)
        return AdamWState(
            torch.zeros((), dtype=torch.int32, device=first.device),
            tree_map(zeros, params), tree_map(zeros, params), master)

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        return (self.lr(count) if callable(self.lr)
                else torch.tensor(self.lr, dtype=torch.float32,
                                  device=count.device))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any
               ) -> Tuple[Any, AdamWState]:
        """One step, in place: ``params``, the state's m, v and master,
        and ``grads`` (scaled by the clip) are overwritten.  Returns
        (params, the state with its count advanced)."""
        count = state.count + 1
        if self.clip_norm is not None:
            scale = torch.clamp_max(
                self.clip_norm / (global_norm(grads) + 1e-9), 1.0)
            for g in leaves(grads):
                g.mul_(scale)
        c = count.float()
        b1c = 1 - self.b1 ** c
        b2c = 1 - self.b2 ** c
        lr = self._lr(count)
        ref = state.master if self.master_weights else params
        for p, r, g, m, v, decay in zip(
                leaves(params), leaves(ref), leaves(grads), leaves(state.m),
                leaves(state.v), _decays(ref)):
            g = g.float()
            m.mul_(self.b1).add_((1 - self.b1) * g)
            g2 = (1 - self.b2) * g
            v.mul_(self.b2).add_(g2.mul_(g))
            del g2
            step = m / b1c
            step.div_((v / b2c).sqrt_().add_(self.eps))
            if self.weight_decay and decay:
                step.add_(self.weight_decay * r)
            r.sub_(step.mul_(lr))
            if r is not p:
                p.copy_(r)
        return params, AdamWState(count, state.m, state.v, state.master)


def global_norm(tree: Any) -> torch.Tensor:
    """The float32 L2 norm of every leaf together."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in leaves(tree)))


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warm-up over ``warmup`` steps, then a cosine from
    ``base_lr`` down to ``floor * base_lr`` at ``total``; float32, from
    the int32 count."""
    def lr(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        warm = c / max(warmup, 1)
        frac = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return base_lr * torch.where(c < warmup, warm, cos)
    return lr
