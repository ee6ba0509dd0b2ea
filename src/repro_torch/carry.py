"""Carry the reference's data and weights, given as numpy arrays, into the port.

``from_numpy`` turns one reference call's arguments
into the port's: arrays become tensors (bfloat16 crosses as its bit
pattern, never re-rounded), a block-ELL matrix becomes the port's
``BlockEll``, a stencil spec is rebuilt field by field into the port's
own frozen ``StencilSpec``, and scalars pass through.  Objects are
recognised by their fields, so nothing of the reference is imported.
``params_from_numpy`` turns the reference's LM parameter pytree (every
family: stacked layers, a hybrid's super-blocks and shared block, an
encoder-decoder's encoder stack and cross-attention, a frontend) into
the port's ``lm.LM`` bit for bit, and ``params_to_numpy`` turns it back;
``adamw_state_from_numpy`` / ``adamw_state_to_numpy`` do the same for the
optimizer's state (its moments and masters of the parameters' shape).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["adamw_state_from_numpy", "adamw_state_to_numpy", "cast",
           "from_numpy", "params_from_numpy", "params_to_numpy",
           "stacked_axes", "tensor"]


def tensor(a: Any, device: str = "cuda") -> torch.Tensor:
    """An array-like as a tensor on ``device``, bit-exact for bfloat16."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                                .view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def cast(a: np.ndarray, dtype: str, device: str = "cuda") -> torch.Tensor:
    """A float64 numpy draw rounded to ``dtype`` on the host, then moved.

    Rounds as ``jnp.asarray(a, dtype)`` does (bfloat16 through float32),
    so a seeded ``make_inputs`` gives the reference's inputs bit for bit.
    """
    return torch.from_numpy(a).to(getattr(torch, dtype)).to(device)


def _carry(x: Any, device: str) -> Any:
    from .kernels.spmv.ref import BlockEll
    from .kernels.stencil.defs import StencilSpec
    if hasattr(x, "blocks") and hasattr(x, "cols") and hasattr(x, "shape"):
        return BlockEll(tensor(x.blocks, device), tensor(x.cols, device),
                        tuple(int(s) for s in x.shape))
    if hasattr(x, "axis_weights") and hasattr(x, "offsets"):
        return StencilSpec(**{f.name: getattr(x, f.name)
                              for f in dataclasses.fields(StencilSpec)})
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return tensor(x, device)
    if isinstance(x, (tuple, list)):
        return type(x)(_carry(e, device) for e in x)
    return x


def from_numpy(args: tuple, kwargs: dict, device: str = "cuda"):
    """One reference call's ``(args, kwargs)`` as the port's."""
    return (tuple(_carry(a, device) for a in args),
            {k: _carry(v, device) for k, v in kwargs.items()})


# --------------------------------------------------------------------------
# model weights
# --------------------------------------------------------------------------

def stacked_axes(cfg) -> dict:
    """The reference's stacked layer groups and their leading layer axes:
    one under ``layers``, ``first_dense`` and ``encoder``, and a hybrid's
    two under ``layers`` (super-block, layer) and one under ``tail``.
    Every other group (``shared_attn``, ``frontend``) is one unstacked
    node."""
    return {"layers": 2 if cfg.family == "hybrid" else 1,
            "first_dense": 1, "encoder": 1, "tail": 1}


def params_from_numpy(tree: dict, cfg, device: str = "cuda"):
    """The reference's LM parameter pytree as the port's ``lm.LM``.

    ``tree`` holds numpy arrays laid out as the reference keeps them:
    ``(d_in, d_out)`` weights for ``x @ W``, and stacked leading layer
    axes under ``"layers"`` (and ``"first_dense"``, ``"encoder"``,
    ``"tail"``).  Layer
    ``i`` of ``layers/attn/wq`` becomes ``layers.<i>.attn.wq``, of
    ``layers/moe/shared/w_up`` ``layers.<i>.moe.shared.w_up``, a hybrid's
    ``layers/ssm/w_z[s, j]`` ``layers.<s>.<j>.ssm.w_z`` and its
    ``shared_attn/attn/wq`` ``shared_attn.attn.wq``; every value crosses
    bit for bit.
    """
    from .models.lm import LM
    axes = stacked_axes(cfg)
    flat = {}
    for key, val in tree.items():
        if not isinstance(val, dict):
            flat[key] = tensor(val, device)
            continue
        n = axes.get(key, 0)
        for path, leaf in _leaves(val):
            arr = np.asarray(leaf)
            for idx in np.ndindex(arr.shape[:n]):
                name = ".".join([key, *map(str, idx), path])
                flat[name] = tensor(arr[idx], device)
    return LM(cfg, flat)


def params_to_numpy(p) -> dict:
    """The inverse of ``params_from_numpy``: the reference's pytree."""
    axes = stacked_axes(p.cfg)
    tree: dict = {}
    stacks: dict = {}
    for key, val in p.state_dict().items():
        arr = val.detach().cpu().numpy()
        group, _, rest = key.partition(".")
        if not rest:
            tree[key] = arr
            continue
        n = axes.get(group, 0)
        *idx, path = rest.split(".", n)
        stacks.setdefault(group, {}).setdefault(path, {})[
            tuple(map(int, idx))] = arr
    for group, leaves in stacks.items():
        nested: dict = {}
        for path, per_layer in leaves.items():
            node = nested
            *parents, leaf = path.split(".")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = _stack_nd(per_layer)
        tree[group] = nested
    return tree


def _stack_nd(per_index: dict) -> np.ndarray:
    """Arrays keyed by index tuples of equal length, stacked over them."""
    if list(per_index) == [()]:
        return per_index[()]
    firsts = sorted({i[0] for i in per_index})
    return np.stack([_stack_nd({i[1:]: a for i, a in per_index.items()
                                if i[0] == f}) for f in firsts])


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


# --------------------------------------------------------------------------
# optimizer state
# --------------------------------------------------------------------------

def adamw_state_from_numpy(state, cfg, device: str = "cuda"):
    """The reference's ``AdamWState`` of an LM's parameters (numpy
    leaves; fields ``count``, ``m``, ``v``, ``master``) as the port's
    ``optim.adamw.AdamWState``, its trees as ``lm.LM`` of ``cfg``."""
    from .optim.adamw import AdamWState

    def tree(t):
        return None if t is None else params_from_numpy(t, cfg, device)
    return AdamWState(tensor(state.count, device), tree(state.m),
                      tree(state.v), tree(state.master))


def adamw_state_to_numpy(state):
    """The inverse of ``adamw_state_from_numpy``: the port's
    ``AdamWState`` with the reference's numpy trees as its fields."""
    from .optim.adamw import AdamWState

    def tree(t):
        return None if t is None else params_to_numpy(t)
    return AdamWState(state.count.cpu().numpy(), tree(state.m),
                      tree(state.v), tree(state.master))
