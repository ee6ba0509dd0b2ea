"""Elastic scaling: describe a mesh transition.

:func:`mesh_transition_plan` is the policy layer's description of one
width change (axis deltas and the data-parallel rescale factor), which the
elastic serving session records with every resize.  Pure Python, copied
from the reference package.

The reference's ``reshard_restore`` (restore a checkpoint onto a mesh of
another device count through ``sharding.rules.fit_spec``) waits for the
measured mesh, ROADMAP Queue 1 item 13.3.
"""
from __future__ import annotations

__all__ = ["mesh_transition_plan"]


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
