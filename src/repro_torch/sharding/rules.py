"""Partition rules: parameter / activation / cache specs per architecture.

The reference's ``rules`` with its specs as tuples: a spec holds one
entry per dimension, an axis name (``"data"``, ``"model"``, ``"pod"``), a
tuple of axis names, or None (not split).  Mesh axes: optional ``"pod"``
(inter-pod data parallelism), ``"data"`` (data parallelism, also the
ZeRO-1 / sequence-parallel axis), ``"model"`` (tensor and expert
parallelism).  Rules go by the parameter's name; a leading stacked layer
dim is transparent (specs are right-aligned against each leaf's trailing
dims), so an ``lm.LM``'s per-layer ``layers.<i>.attn.wq`` gets the spec
of the reference's stacked ``layers/attn/wq`` without its layer dims.

:func:`to_shardings` binds specs to a mesh: each :class:`Sharding` gives
a rank its slice of a leaf (``local``) and puts a leaf back together from
the slices of its axes' ranks (``gather``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = ["MODEL", "Sharding", "batch_spec", "cache_pspecs", "fit_spec",
           "fsdp_pspecs", "input_pspecs", "param_pspecs", "to_shardings",
           "zero1_pspecs"]

Spec = Tuple[Any, ...]

MODEL = "model"


def _base_spec(name: str, path: Tuple[str, ...]) -> Spec:
    """The spec of a parameter leaf by its name (``path`` tells the MoE's
    routed experts from its shared ones)."""
    in_moe = "moe" in path and "shared" not in path
    table = {
        "embed": (MODEL, None),
        "head": (None, MODEL),
        # attention
        "wq": (None, MODEL), "wk": (None, MODEL), "wv": (None, MODEL),
        "bq": (MODEL,), "bk": (MODEL,), "bv": (MODEL,),
        "wo": (MODEL, None),
        # MLA
        "wq_a": (None, None), "wq_b": (None, MODEL),
        "wkv_a": (None, None), "wkv_b": (None, MODEL),
        # mlp
        "w_gate": (MODEL, None, None) if in_moe else (None, MODEL),
        "w_up": (MODEL, None, None) if in_moe else (None, MODEL),
        "w_down": (MODEL, None, None) if in_moe else (MODEL, None),
        "router": (None, None),
        # ssm
        "w_z": (None, MODEL), "w_x": (None, MODEL),
        "w_bc": (None, None), "w_dt": (None, MODEL),
        "conv_x": (None, MODEL), "conv_x_b": (MODEL,),
        "conv_bc": (None, None), "conv_bc_b": (None,),
        "a_log": (MODEL,), "dt_bias": (MODEL,), "d_skip": (MODEL,),
        "norm": (MODEL,),
        "out_proj": (MODEL, None),
        # frontend
        "proj": (None, None), "bias": (None,),
    }
    return table.get(name, ())  # norms and scalars replicate


def _right_align(spec: Spec, ndim: int) -> Spec:
    """Pad a trailing-dims spec with leading Nones (stacked dims)."""
    pad = ndim - len(spec)
    assert pad >= 0, (spec, ndim)
    return (None,) * pad + tuple(spec)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def fit_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop axes whose dim they do not divide; move a dropped axis to the
    largest unsplit dim it divides (the reference's rule: an explicit
    split must divide exactly)."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    dropped = []
    for i, ax in enumerate(spec):
        if ax is not None and shape[i] % _axis_size(mesh, ax) != 0:
            dropped.append(ax)
            spec[i] = None
    for ax in dropped:
        cands = [(i, shape[i]) for i in range(len(shape))
                 if spec[i] is None and shape[i] % _axis_size(mesh, ax) == 0
                 and shape[i] > 1]
        if cands:
            i, _ = max(cands, key=lambda t: t[1])
            spec[i] = ax
    return tuple(spec)


def _names(path: Sequence[str]) -> Tuple[str, ...]:
    """A leaf's path without its layer indices."""
    return tuple(p for p in path if not str(p).isdigit())


def _map(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree: an ``nn.Module`` maps to a dict of
    its parameter names, a dict / list / tuple keeps its structure, any
    object with a ``shape`` is a leaf."""
    if isinstance(tree, nn.Module):
        return {n: fn(path + tuple(n.split(".")), t)
                for n, t in sorted(tree.named_parameters())}
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "shape"):
        out = [_map(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    if tree is None:
        return None
    return fn(path, tree)


def param_pspecs(params: Any, mesh=None) -> Any:
    """Specs for a parameter tree (an ``lm.LM``: a dict by parameter
    name) or any tree of its shape (grads, optimizer moments); with a
    mesh, fitted to its divisibility."""
    def spec_for(path, leaf):
        names = _names(path)
        base = _base_spec(names[-1], names) if names else ()
        spec = _right_align(base, len(leaf.shape))
        return (fit_spec(spec, tuple(leaf.shape), mesh)
                if mesh is not None else spec)
    return _map(spec_for, params)


def zero1_pspecs(params: Any, mesh=None, data_axis: str = "data") -> Any:
    """ZeRO-1: optimizer moments also split over the data axis on their
    largest dim not split yet."""
    def spec_for(path, leaf):
        names = _names(path)
        shape = tuple(leaf.shape)
        base = _base_spec(names[-1], names) if names else ()
        spec = list(_right_align(base, len(shape)))
        if mesh is not None:
            spec = list(fit_spec(tuple(spec), shape, mesh))
        if len(shape) >= 2:
            dsize = _axis_size(mesh, data_axis) if mesh is not None else 1
            dims = [(i, shape[i]) for i in range(len(shape))
                    if spec[i] is None and shape[i] % max(dsize, 1) == 0]
            if dims:
                i, _ = max(dims, key=lambda t: t[1])
                spec[i] = data_axis
        return tuple(spec)
    return _map(spec_for, params)


def fsdp_pspecs(params: Any, mesh) -> Any:
    """ZeRO-3: every parameter split over all mesh axes at once, on its
    largest dim they divide; tiny tensors replicate."""
    axes = tuple(mesh.axis_names)
    total = 1
    for a in axes:
        total *= mesh.shape[a]

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % total == 0:
                spec = [None] * len(shape)
                spec[i] = axes
                return tuple(spec)
        return ()
    return _map(spec_for, params)


def _dp_axes(mesh) -> Any:
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def batch_spec(mesh, *leading_data: bool) -> Spec:
    """The spec of an activation whose dim 0 is the global batch."""
    return (_dp_axes(mesh),)


def input_pspecs(cfg, mesh, kind: str, seq_shard: bool = False) -> dict:
    """Specs of a step's input batch (``kind`` "train" or "prefill")."""
    dp = _dp_axes(mesh)
    if kind in ("train", "prefill"):
        specs = {"tokens": (dp, None), "labels": (dp, None),
                 "loss_mask": (dp, None)}
        if cfg.frontend == "vision":
            specs["vision_embeds"] = (dp, None, None)
        if cfg.enc_dec:
            specs["enc_frames"] = (dp, None, None)
        if kind == "prefill":
            specs.pop("labels")
            specs.pop("loss_mask")
        return specs
    raise ValueError(kind)


def cache_pspecs(cfg, mesh, caches: Any, seq_shard: bool = False) -> Any:
    """Specs of the decode caches (``lm.init_caches``' tree): batch over
    the data axes, heads over the model axis; ``seq_shard`` splits the
    cache's sequence over the data axis instead (long context, batch 1)."""
    dp = _dp_axes(mesh)

    def spec_for(path, leaf):
        name = _names(path)[-1]
        if name in ("k", "v", "ck", "cv"):       # (..., B, S, KH, Dh)
            base = ((None, dp, MODEL, None) if seq_shard
                    else (dp, None, MODEL, None))
        elif name in ("k_scale", "v_scale"):     # (..., B, S, KH)
            base = (None, dp, MODEL) if seq_shard else (dp, None, MODEL)
        elif name in ("latent", "k_rope"):       # (..., B, S, r)
            base = (None, dp, None) if seq_shard else (dp, None, None)
        elif name == "ssm":                      # (..., B, H, P, N)
            base = ((None, MODEL, None, None) if seq_shard
                    else (dp, MODEL, None, None))
        elif name == "conv_x":                   # (..., B, K-1, di)
            base = (None, None, MODEL) if seq_shard else (dp, None, MODEL)
        elif name == "conv_bc":                  # (..., B, K-1, 2gn)
            base = (None, None, None) if seq_shard else (dp, None, None)
        else:
            base = ()
        return fit_spec(_right_align(base, len(leaf.shape)),
                        tuple(leaf.shape), mesh)
    return _map(spec_for, caches)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec bound to a mesh: which slice of a leaf each rank holds."""

    mesh: Any
    spec: Spec

    def _axes(self, entry) -> Tuple[str, ...]:
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def _pos(self, rank: int, entry) -> int:
        """Rank *rank*'s position along a spec entry's axes."""
        coords = dict(zip(self.mesh.axis_names, self.mesh.coords(rank)))
        pos = 0
        for ax in self._axes(entry):
            pos = pos * self.mesh.shape[ax] + coords[ax]
        return pos

    def index(self, rank: int, shape) -> Tuple[slice, ...]:
        """Rank *rank*'s slice of a leaf of *shape*."""
        out = []
        for dim, entry in zip(shape, _right_align(self.spec, len(shape))):
            parts = _axis_size(self.mesh, entry)
            step = dim // parts
            pos = self._pos(rank, entry)
            out.append(slice(pos * step, (pos + 1) * step))
        return tuple(out)

    def local(self, leaf: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank *rank*'s slice of *leaf*, as a tensor of its own."""
        return leaf[self.index(rank, tuple(leaf.shape))].clone()

    def split_dims(self, ndim: int) -> Tuple[int, ...]:
        """The dims the spec splits."""
        return tuple(i for i, e in enumerate(_right_align(self.spec, ndim))
                     if e is not None)

    def peers(self, rank: int) -> Tuple[int, ...]:
        """The ranks whose slices make up the whole leaf with *rank*'s
        (those that differ from it only along the spec's axes), in the
        order their slices stack."""
        axes = {ax for entry in self.spec for ax in self._axes(entry)}
        names = self.mesh.axis_names
        here = self.mesh.coords(rank)
        same = [r for r in range(self.mesh.size)
                if all(c == h for c, h, a in
                       zip(self.mesh.coords(r), here, names)
                       if a not in axes)]
        split = [e for e in self.spec if e is not None]
        return tuple(sorted(same, key=lambda r: [self._pos(r, e)
                                                 for e in split]))

    def gather(self, group, local: torch.Tensor,
               shape) -> torch.Tensor:
        """The whole leaf from every rank's slice over ``group`` (the
        gloo group of ``peers``, in that order).  A spec that splits one
        dim (every rule here does) stacks the slices along it."""
        dims = self.split_dims(len(shape))
        if not dims:
            return local
        assert len(dims) == 1, self.spec
        return torch.cat(group.all_gather(local), dim=dims[0])


def _is_spec(node: Any) -> bool:
    return isinstance(node, tuple) and not hasattr(node, "_fields") and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in node)


def to_shardings(mesh, pspecs: Any) -> Any:
    """Bind a spec tree to *mesh*: a tree of :class:`Sharding`."""
    if _is_spec(pspecs):
        return Sharding(mesh, pspecs)
    if isinstance(pspecs, dict):
        return {k: to_shardings(mesh, v) for k, v in pspecs.items()}
    if isinstance(pspecs, (tuple, list)):
        out = [to_shardings(mesh, v) for v in pspecs]
        return type(pspecs)(*out) if hasattr(pspecs, "_fields") else \
            type(pspecs)(out)
    return pspecs
