"""Elastic scaling: restore a checkpoint onto another mesh.

A checkpoint saved on one mesh restores onto a mesh of another shape:
the leaves load on the host, and each rank takes its slice under the new
mesh's specs (``sharding.rules.param_pspecs``, divisibility-aware through
``fit_spec``).  :func:`mesh_transition_plan` describes one width change
(axis deltas and the data-parallel rescale factor), which the elastic
serving session records with every resize.

On a real cluster this is the node-failure recovery path: drop to the
surviving slice, restore, continue; scale back up at the next boundary.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..sharding import rules
from . import checkpoint as ckpt

__all__ = ["local_slices", "mesh_transition_plan", "reshard_restore",
           "restore_on"]


def local_slices(state: Any, shardings: Any, rank: int) -> Any:
    """Rank *rank*'s slice of every leaf of *state* under *shardings*
    (``rules.to_shardings`` of its specs); an ``lm.LM`` maps to an LM of
    the slices."""
    if state is None:
        return None
    if isinstance(state, nn.Module):
        from ..models.lm import LM
        return LM(state.cfg, {n: shardings[n].local(t.detach(), rank)
                              for n, t in state.named_parameters()})
    if isinstance(state, dict):
        return {k: local_slices(v, shardings[k], rank)
                for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        out = [local_slices(v, s, rank) for v, s in zip(state, shardings)]
        return type(state)(*out) if hasattr(state, "_fields") else \
            type(state)(out)
    return shardings.local(state, rank)


def reshard_restore(ckpt_dir: str, template: Any, new_mesh,
                    step: Optional[int] = None,
                    rank: Optional[int] = None) -> Tuple[Any, int]:
    """Restore ``template``-shaped state onto ``new_mesh``.

    Returns (state, step).  With ``rank`` the state is that rank's slices
    under the new mesh's specs; without, the whole leaves (what the
    reference's global arrays hold).  Works across any change of shape as
    long as the new axes divide (``fit_spec`` drops or moves the rest).
    """
    if step is None:
        step = ckpt.latest_step(ckpt_dir)
    state = ckpt.restore(ckpt_dir, template, step=step)
    if rank is not None:
        shardings = rules.to_shardings(
            new_mesh, rules.param_pspecs(template, new_mesh))
        state = local_slices(state, shardings, rank)
    return state, step


def _restore_rank(ctx, ckpt_dir: str, cfg, shape: tuple, axes: tuple,
                  device: str, step: Optional[int],
                  train_state: bool) -> Dict[str, Any]:
    from ..launch.mesh import make_auto_mesh
    from ..models import lm
    dev = torch.device("cuda", 0) if device == "cuda" else \
        torch.device("cpu")
    template = lm.init_params(cfg, seed=0, device=dev)
    state, _ = reshard_restore(ckpt_dir,
                               (template, None) if train_state else template,
                               make_auto_mesh(shape, axes), step=step,
                               rank=ctx.rank)
    params = state[0] if train_state else state
    return {n: t.detach() for n, t in params.named_parameters()}


def restore_on(mesh, ckpt_dir: str, cfg, device: str = "cuda",
               step: Optional[int] = None,
               train_state: bool = False) -> List[Dict[str, Any]]:
    """:func:`reshard_restore` of an LM's parameters on every rank of the
    live *mesh* at once: each rank's slices by parameter name, in rank
    order.  ``train_state``: the checkpoint holds (parameters, optimizer
    state), as ``launch.train`` writes it."""
    args = (str(ckpt_dir), cfg, tuple(mesh.shape.values()),
            tuple(mesh.axis_names), device, step, train_state)
    return mesh.live().call(mesh.size, _restore_rank, [args] * mesh.size)


def mesh_transition_plan(old_shape: dict, new_shape: dict) -> dict:
    """Describe the transition (for logs/controller): axis deltas and the
    data-parallel rescale factor (per-host batch changes inversely)."""
    old_dp = old_shape.get("data", 1) * old_shape.get("pod", 1)
    new_dp = new_shape.get("data", 1) * new_shape.get("pod", 1)
    return {
        "old": dict(old_shape), "new": dict(new_shape),
        "dp_rescale": new_dp / old_dp,
        "tp_change": new_shape.get("model", 1) != old_shape.get("model", 1),
    }
