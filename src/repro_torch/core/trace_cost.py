"""FLOP and byte accounting of a step traced on meta tensors.

The counterpart of the reference's ``core/jaxpr_cost.py``, which walks a
jaxpr.  Here the step runs eagerly on tensors of the ``meta`` device
(shapes and dtypes, no storage) under a ``TorchDispatchMode`` that sees
every aten op:

  * ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` (and ``mv`` / ``dot``):
    2 * B * M * N * K into ``dot_flops`` (the matrix term), plus their
    operand and output bytes; ``einsum`` and ``@`` reach them by
    decomposition;
  * elementwise ops: one flop per output element, transcendentals a few
    (the reference's table); a fused op (``silu``, ``_softmax``) counts
    the reference's primitives it stands for; reductions one flop per
    input element;
  * memory-shaped ops (gather, scatter, index, cat, pad, sort, flip, the
    copy into a slice that is the reference's ``dynamic_update_slice``,
    counted as it is, with the whole buffer in and out): their operand
    and output bytes.  A view (slice, permute, transpose, reshape) costs
    no bytes; a permuted view moves its bytes when a ``clone`` copies it
    (a ``reshape`` or ``contiguous`` of it), and that copy is counted.
    The reference's jaxpr also has the ``transpose``s JAX's lowering
    issues (an einsum's output order, ``dot_general``'s backward); the
    port's program does not move those bytes and does not count them.
    The copy into one layer's slot of a stacked tensor costs nothing (the
    reference's layer scan returns its outputs stacked, with no
    primitive); a matmul's operand broadcast over a batch is read once.

Backward passes and ``torch.utils.checkpoint``'s recompute run under the
mode, which stays active through autograd: a recomputed forward is
counted, as the reference counts remat's.

The port's layers are a Python loop, traced layer by layer, so the
undercount that the reference's walker exists to fix (XLA's
``cost_analysis`` counts a scan body once) has no counterpart here: full
depth is counted directly.  A tracer may still run one pass of a loop of
identical chunks under ``repeated(n)`` and count it n times, the
reference's ``length * cost(body)`` of a scan; ``folding()`` says whether
it may (a mode that folds is active and no autograd graph records: a
backward pass would run outside the loop).

Bytes are a fusion-aware estimate, as the reference's: only
memory-shaped ops and dots count, pointwise chains are taken as fused,
and the program's inputs and outputs count once each (``io_bytes``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Iterator, List

import torch
from torch import nn
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

__all__ = ["Cost", "CostMode", "counted", "folding", "op_cost",
           "program_cost", "repeated", "tensors_of"]

ELEMENTWISE_1 = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "floor", "ceil", "round", "sign", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "logical_and", "logical_or",
    "logical_xor", "logical_not", "where", "masked_fill", "clamp",
    "clamp_min", "clamp_max", "remainder", "fmod", "pow", "atan2",
    "nextafter", "reciprocal", "threshold_backward",
}
ELEMENTWISE_N = {  # transcendental, fused or backward: flops per element
    "exp": 4, "log": 4, "log1p": 4, "expm1": 4, "tanh": 6, "sigmoid": 6,
    "sin": 4, "cos": 4, "rsqrt": 2, "sqrt": 2, "erf": 6, "exp2": 4,
    "integer_pow": 2, "silu": 7, "softplus": 11,
    "_softmax": 8, "_log_softmax": 8,
    "_softmax_backward_data": 4, "_log_softmax_backward_data": 4,
    "tanh_backward": 3, "sigmoid_backward": 3, "silu_backward": 10,
}
REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
    "argmin", "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "all", "any", "logsumexp", "norm",
}
MEMORY_OPS = {
    "gather", "scatter", "scatter_add", "scatter_reduce", "index",
    "_unsafe_index", "index_select", "index_put", "_index_put_impl",
    "_unsafe_index_put", "index_add", "index_copy", "embedding",
    "embedding_dense_backward", "cat", "stack", "constant_pad_nd", "pad",
    "flip", "sort", "slice_scatter", "select_scatter", "slice_backward",
    "select_backward", "clone", "copy", "masked_scatter",
}
DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _stored_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` reads: an expanded (stride 0) dim counts once, as
    a matmul that broadcasts a weight over a batch reads it once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


def tensors_of(obj: Any) -> List[torch.Tensor]:
    """Every tensor in ``obj``: an ``nn.Module``'s parameters and buffers,
    the leaves of dicts, lists and tuples (named ones too)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in tensors_of(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in tensors_of(v)]
    return []


@dataclasses.dataclass
class Cost:
    """FLOPs (all of them, and the dots' share) and bytes."""

    flops: float = 0.0
    dot_flops: float = 0.0
    bytes: float = 0.0

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.dot_flops += o.dot_flops
        self.bytes += o.bytes
        return self

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.dot_flops * k, self.bytes * k)


def _dot_flops(name: str, args) -> float:
    if name in ("addmm", "baddbmm"):
        args = args[1:]
    a, b = args[0], args[1]
    if name == "dot":
        return 2.0 * a.shape[0]
    if name == "mv":
        return 2.0 * a.shape[0] * a.shape[1]
    batch = a.shape[0] if name in ("bmm", "baddbmm") else 1
    m, k = a.shape[-2], a.shape[-1]
    return 2.0 * batch * m * b.shape[-1] * k


def op_cost(func, args, out, buffer: int = 0) -> Cost:
    """The cost of one aten op call: ``func`` on ``args`` gave ``out``.
    ``buffer``: for a copy into a slice, the bytes of the tensor sliced."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]                       # in place: add_ -> add
    if name == "pow" and func._overloadname == "Tensor_Scalar":
        name = "integer_pow"
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    if name in DOTS:
        ins = [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
        flops = _dot_flops(name, args)
        byts = (sum(_stored_bytes(t) for t in ins)
                + sum(_nbytes(t) for t in outs))
        extra = (sum(t.numel() for t in outs)
                 if name in ("addmm", "baddbmm") else 0.0)
        return Cost(flops=flops + extra, dot_flops=flops, bytes=byts)
    if name in ELEMENTWISE_1:
        return Cost(flops=float(sum(t.numel() for t in outs)))
    if name in ELEMENTWISE_N:
        return Cost(flops=float(ELEMENTWISE_N[name])
                    * sum(t.numel() for t in outs))
    if name in REDUCE:
        ins = [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
        per = 7.0 if name == "logsumexp" else 1.0
        return Cost(flops=per * float(ins[0].numel() if ins else 0))
    if name in MEMORY_OPS:
        ins = [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
        if name == "copy":
            # a write into a slice of a buffer is the reference's
            # ``dynamic_update_slice``: the buffer in, the update, the
            # buffer out; a whole copy is its source and destination
            if buffer:
                return Cost(bytes=float(2 * buffer + _nbytes(ins[1])))
            ins = ins[1:]
        if not outs and ins:                   # in place, nothing returned
            outs = ins[:1]
        return Cost(bytes=float(sum(_nbytes(t) for t in ins)
                                + sum(_nbytes(t) for t in outs)))
    return Cost()


class CostMode(TorchDispatchMode):
    """Counts ``op_cost`` of every op run under it into ``cost``, each
    ``scale`` times (``repeated``).  It remembers which tensor each slice
    was taken from, so that a copy into the slice counts that tensor as
    the reference's ``dynamic_update_slice`` counts its operand; a copy
    into one layer's slot of a stacked tensor (a ``select``) is the
    port's in-place form of what the reference's layer scan returns
    stacked, and costs nothing, as the scan's outputs cost nothing
    there."""

    #: a mode that counts folded loops (``repeated``) through ``scale``
    folds = True

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.scale = 1.0
        self._sliced: Dict[int, tuple] = {}

    def _sliced_from(self, t: torch.Tensor) -> int:
        ref, nbytes = self._sliced.get(id(t), (None, 0))
        return nbytes if ref is not None and ref() is t else 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        buffer = 0
        if name in ("slice", "select") and isinstance(out, torch.Tensor):
            self._sliced[id(out)] = (weakref.ref(out), -1 if name == "select"
                                     else _nbytes(args[0]))
        elif name in ("copy_", "copy") and isinstance(args[0], torch.Tensor):
            buffer = self._sliced_from(args[0])
            if buffer < 0:
                return out
        self.add(op_cost(func, args, out, buffer))
        return out

    def add(self, c: Cost) -> None:
        """Count ``c``, ``scale`` times."""
        self.cost += c.scaled(self.scale)


def _folding_modes() -> List[Any]:
    return [m for m in _get_current_dispatch_mode_stack()
            if getattr(type(m), "folds", False)]


def folding() -> bool:
    """Whether a loop of identical chunks may run one chunk for all: a
    mode that folds is active and no autograd graph records."""
    return bool(_folding_modes()) and not torch.is_grad_enabled()


@contextlib.contextmanager
def repeated(n: int) -> Iterator[None]:
    """Count what runs inside ``n`` times in every folding mode."""
    modes = _folding_modes()
    for m in modes:
        m.scale *= n
    try:
        yield
    finally:
        for m in modes:
            m.scale /= n


def program_cost(fn, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn`` on meta tensors under ``CostMode`` and count the global
    FLOPs and bytes: the reference's keys ``flops``, ``dot_flops``,
    ``bytes`` (the ops' plus ``io_bytes``) and ``io_bytes`` (every input
    and output tensor once)."""
    return counted(CostMode(), fn, *args, **kwargs)


def counted(mode: CostMode, fn, *args, **kwargs) -> Dict[str, float]:
    """``program_cost`` counted by ``mode`` (a ``CostMode``, or a subclass
    that attributes what it counts)."""
    with mode:
        out = fn(*args, **kwargs)
    io = (sum(_nbytes(t) for t in tensors_of((args, kwargs)))
          + sum(_nbytes(t) for t in tensors_of(out)))
    c = mode.cost
    return {"flops": c.flops, "dot_flops": c.dot_flops,
            "bytes": c.bytes + io, "io_bytes": float(io)}
