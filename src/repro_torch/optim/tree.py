"""Parameter trees: the port's stand-in for the reference's pytrees.

A tree is an ``lm.LM`` (its parameters), a dict (its values), a
tuple or list, a tensor (one leaf) or None (no leaf).  The optimizer
state, the gradients and a checkpoint's contents are trees of the
parameters' shape.  Leaves come in the order of their names (an LM's
parameter names, a dict's keys, as ``jax.tree.leaves`` orders a dict),
so two trees of one shape line up leaf for leaf however each was built.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from torch import nn

__all__ = ["leaves", "named_leaves", "tree_map"]


def named_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(dotted name, leaf) pairs in tree order."""
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        return [(prefix + n, t) for n, t in sorted(tree.named_parameters())]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, t in enumerate(tree)
                for pair in named_leaves(t, f"{prefix}{i}.")]
    return [(prefix.rstrip("."), tree)]


def leaves(tree: Any) -> List[Any]:
    """The leaves in tree order."""
    return [t for _, t in named_leaves(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``fn`` of the
    leaves of ``tree`` and ``rest`` (trees of the same structure).  An
    ``LM`` maps to an ``LM`` of the same config."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        from ..models.lm import LM
        others = [dict(r.named_parameters()) for r in rest]
        return LM(tree.cfg, {n: fn(t, *(o[n] for o in others))
                             for n, t in tree.named_parameters()})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree, *rest)

