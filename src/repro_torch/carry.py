"""Carry the reference's data and weights, given as numpy arrays, into the port.

``from_numpy`` turns one reference call's arguments
into the port's: arrays become tensors (bfloat16 crosses as its bit
pattern, never re-rounded), a block-ELL matrix becomes the port's
``BlockEll``, a stencil spec is rebuilt field by field into the port's
own frozen ``StencilSpec``, and scalars pass through.  Objects are
recognised by their fields, so nothing of the reference is imported.
``params_from_numpy`` turns the reference's LM parameter pytree into the
port's ``lm.LM`` bit for bit, and ``params_to_numpy`` turns it back.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["cast", "from_numpy", "params_from_numpy", "params_to_numpy",
           "tensor"]


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

#: The reference's stacked layer groups: one leading layer axis each.
STACKED = ("layers", "first_dense")


def params_from_numpy(tree: dict, cfg, device: str = "cuda"):
    """The reference's LM parameter pytree as the port's ``lm.LM``.

    ``tree`` holds numpy arrays laid out as the reference keeps them:
    ``(d_in, d_out)`` weights for ``x @ W``, and one stacked leading layer
    axis under ``"layers"`` (and ``"first_dense"``).  Layer ``i`` of
    ``layers/attn/wq`` becomes ``layers.<i>.attn.wq``, of
    ``layers/moe/shared/w_up`` ``layers.<i>.moe.shared.w_up``; every value
    crosses bit for bit.
    """
    from .models.lm import LM
    flat = {}
    for key, val in tree.items():
        if key not in STACKED:
            flat[key] = tensor(val, device)
            continue
        for path, leaf in _leaves(val):
            arr = np.asarray(leaf)
            for i in range(arr.shape[0]):
                flat[f"{key}.{i}.{path}"] = tensor(arr[i], device)
    return LM(cfg, flat)


def params_to_numpy(p) -> dict:
    """The inverse of ``params_from_numpy``: the reference's pytree."""
    tree: dict = {}
    stacks: dict = {}
    for key, val in p.state_dict().items():
        arr = val.detach().cpu().numpy()
        group, _, rest = key.partition(".")
        if group not in STACKED:
            tree[key] = arr
            continue
        i, path = rest.split(".", 1)
        stacks.setdefault(group, {}).setdefault(path, {})[int(i)] = arr
    for group, layers in stacks.items():
        nested: dict = {}
        for path, per_layer in layers.items():
            node = nested
            *parents, leaf = path.split(".")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = np.stack([per_layer[i] for i in sorted(per_layer)])
        tree[group] = nested
    return tree


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val
