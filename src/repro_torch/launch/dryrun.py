"""Multi-pod dry run: trace every (arch x cell x mesh) step on meta
tensors and derive its roofline terms.

The reference lowers and compiles each cell's jitted step against 512
forced XLA host devices and mines the compiled program for its memory,
cost and collective bytes (``src/repro/launch/dryrun.py``).  Here nothing
is compiled and nothing is allocated; per cell:

* **Global cost.**  ``core.trace_cost.program_cost`` of the unsharded
  step on meta tensors: FLOPs, dot FLOPs and bytes (the reference's
  jaxpr walker).
* **The sharded trace.**  A fake process group of 256 ranks (512 with
  ``--multipod``) lives in this one process (``torch.distributed``'s
  ``fake`` backend: a collective returns at once and moves nothing), under
  a ``DeviceMesh`` of the reference's shape and axis names
  (``launch/mesh.py``).  Parameters, optimizer state, batch and caches
  are DTensors whose local tensors are on meta, placed by
  ``sharding/rules.py``'s specs after ``fit_spec``: an axis of a spec
  entry is ``Shard(dim)`` on that mesh dim, None is ``Replicate()``.
  The step runs once; DTensor propagates the shardings
  op by op and issues the collectives a real mesh would run.  The ``sp``
  / ``fsdp`` layouts pin their ``act_spec`` onto the residual stream
  after every layer as a redistribution, and a partial sum added to the
  residual stream is reduced onto its placement.  The outputs are
  redistributed to the reference's out shardings.
* **What DTensor does not propagate** is traced as the layout the
  reference's specs give (``traced_model``): attention's core
  head-parallel on each device's shard, the loss vocab-parallel, a MoE
  layer expert-parallel, an embedding lookup as DTensor's masked
  embedding.  Where the query or KV heads do not divide the model axis
  (Qwen1.5-32B's 40 heads, Mistral-NeMo-12B's 8 KV heads over 16), a
  train or prefill step pads them up to it (``tp_config``); a decode step
  gathers q / k / v over it before the reshape into heads, runs every
  head on each device's batch shard, and attends the cache, which
  ``fit_spec`` then splits by sequence over the model axis,
  split-sequence (``_gathered_heads``).  A move of a split from one dim
  to another counts as the all-to-all a card runs, not the whole gather
  a CPU mesh makes of it.
* **What the trace records.**  A dispatch mode under DTensor sees the
  local ops: each functional collective with its local result bytes
  (``core.analysis.collective_stats``), and the live local bytes.
  ``bytes_per_device`` holds ``arguments`` (the inputs' shards),
  ``output`` (the outputs' shards; an output updated in place is counted
  there too, as the reference counts a donated one), ``temp`` (the peak
  of live intermediates) and their sum ``total_gb``.  ``temp`` is an
  upper estimate: eager autograd holds what it saves, with none of the
  buffer reuse and fusion of XLA's buffer assignment.  A serving step
  traces the reference's float32 weights (bfloat16 ones under
  ``--params-dtype bf16`` at decode, as the reference's), cast to the
  step's dtype inside the trace.  ``collectives`` also holds
  ``bf16_bytes_by_kind``, the bytes of its bfloat16 collectives: XLA's
  CPU backend reduces those in float32 (its ``all-reduce-promotion``
  pass), so a reference row compiled on the CPU counts them twice.
* **Ops DTensor does not shard.**  Where DTensor has no sharding rule
  for an op or its placements (``unfold``; a view that merges two split
  dims), the row is an error row naming the op, as the reference records
  a failed compile.
  Nothing is rerun on other placements and nothing falls back to an
  unsharded trace.
* **No depth extrapolation.**  The reference compiles two shallow
  variants and extrapolates, because XLA prints the collectives inside a
  scan once (``dryrun.py:159-189``).  The port's layers are a Python loop
  traced layer by layer, so full depth is counted directly, and
  ``xla_cost_flops_per_dev_loops_once`` (XLA's own undercounted figure)
  is null.
* **Terms.**  ``t_compute`` = FLOPs / (chips x the spec's dense peak at
  the step's dtype), ``t_memory`` = bytes / (chips x ``mem_bw``),
  ``t_collective`` = collective bytes per device / ``link_bw`` (per
  link, as the reference's).  ``--hw`` picks the spec: ``h100`` (the
  SXM5 the port runs on, the default) or ``v5e`` (the reference's
  terms).

Usage:
  python -m repro_torch.launch.dryrun --arch mistral-nemo-12b --cell train_4k
  python -m repro_torch.launch.dryrun --all [--multipod] [--out F]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, List, Optional, Tuple

import torch

from ..configs import ARCHS, get_arch
from ..core import trace_cost
from ..core.analysis import EVENT_KINDS, collective_stats
from ..core.hw import H100_SXM, HardwareSpec, dense_peak, get_platform
from ..core.trace_cost import program_cost, tensors_of
from ..models import lm
from ..models.config import ModelConfig
from ..obs.log import LOG
from ..optim.adamw import AdamW, AdamWState
from ..sharding import rules
from . import steps
from .cells import CELLS, Cell, applicable
from .mesh import Mesh, make_production_mesh

__all__ = ["ShardedTrace", "UnshardableOp", "device_mesh", "distribute",
           "lower_cell", "main", "tp_config", "trace_cell", "trace_sharded",
           "traced_model"]

DEFAULT_OUT = "build/runs_torch/dryrun.json"

_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


class UnshardableOp(RuntimeError):
    """An op the sharded trace cannot place: DTensor refuses its
    shardings, or a layer's split does not fit the mesh.  The row is an
    error row naming it."""


# --------------------------------------------------------------------------
# the fake world and its mesh
# --------------------------------------------------------------------------

def _fake_world(size: int) -> None:
    """Make the default process group a fake one of ``size`` ranks, this
    process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs the default process group "
                               "and this process already has a real one")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    _forget_meshes()


def _forget_meshes() -> None:
    """Clear DTensor's sharding-propagation caches (the Python ones and the
    C++ dispatch fast path's).  They key an op by its specs, whose meshes
    compare equal across worlds (shape and names, not groups): a hit would
    hand back a mesh of a destroyed world, whose groups no longer
    resolve."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    for name in ("propagate_op_sharding", "_propagate_tensor_meta_cached"):
        clear = getattr(getattr(prop, name, None), "cache_clear", None)
        if clear is not None:
            clear()
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                    None)
    if clear is not None:
        clear()


def device_mesh(shape, axis_names):
    """A ``DeviceMesh`` of ``shape`` over a fake world of its size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    _fake_world(size)
    return init_device_mesh("cpu", shape, mesh_dim_names=tuple(axis_names))


def _placements(spec, ndim: int, dmesh) -> list:
    from torch.distributed.tensor import Replicate, Shard
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    out = [Replicate()] * dmesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[dmesh.mesh_dim_names.index(ax)] = Shard(dim)
    return out


def _dtensor(t: torch.Tensor, spec, dmesh):
    """A DTensor of ``t``'s shape and dtype placed by ``spec``, its local
    tensor on meta."""
    from torch.distributed.tensor import DTensor, Shard
    pl = _placements(spec, t.ndim, dmesh)
    local = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= dmesh.size(i)
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), dmesh, pl,
        run_check=False, shape=t.shape,
        stride=torch.empty(t.shape, device="meta").stride())


def distribute(tree: Any, specs: Any, dmesh) -> Any:
    """``tree`` (an ``lm.LM``, dicts, named tuples, tensors) with every
    tensor leaf a DTensor placed by the same-shaped ``specs`` (an LM's
    specs are a dict by parameter name, as ``rules.param_pspecs``
    gives)."""
    if tree is None:
        return None
    if isinstance(tree, lm.LM):
        return lm.LM(tree.cfg, {n: _dtensor(t, specs[n], dmesh)
                                for n, t in tree.named_parameters()})
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], dmesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(v, s, dmesh)
                            for v, s in zip(tree, specs)))
    return _dtensor(tree, specs, dmesh)


def _redistribute(tree: Any, specs: Any, dmesh) -> Any:
    """Every DTensor of ``tree`` moved to the placement of ``specs``
    (None: replicated)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _redistribute(v, None if specs is None else specs[k],
                                 dmesh) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.redistribute(dmesh, _placements(specs or (), tree.ndim,
                                                    dmesh))
    return tree


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------

def _is_dtensor_call(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _make_recorder():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Recorder(TorchDispatchMode):
        """Under DTensor: the local ops.  Records functional collectives
        ``(op, local result bytes)``, each ``scale`` times (a folded
        chunk loop, ``trace_cost.repeated``), the bfloat16 ones also in
        ``bf16_events``.  ``track`` keeps the live
        bytes that the ops above DTensor allocate, and their peak."""

        folds = True

        def __init__(self):
            super().__init__()
            self.events: List[Tuple[str, int]] = []
            self.bf16_events: List[Tuple[str, int]] = []
            self.live = 0
            self.peak = 0
            self.scale = 1.0

        def _free(self, nbytes: int) -> None:
            self.live -= nbytes

        def track(self, func, out) -> None:
            """Count the storage of each output ``func`` allocated (a
            DTensor's local one) until it is freed."""
            for r, t in zip(func._schema.returns, tree_flatten(out)[0]):
                if isinstance(t, torch.Tensor) and r.alias_info is None:
                    st = getattr(t, "_local_tensor", t).untyped_storage()
                    self.live += st.nbytes()
                    weakref.finalize(st, self._free, st.nbytes())
            self.peak = max(self.peak, self.live)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _is_dtensor_call(types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if func.namespace == "_dtensor" and name == "shard_dim_alltoall":
                name = "all_to_all_single"         # ``_all_to_all``'s
            elif not func.namespace.startswith("_c10d_functional"):
                return out
            if name in EVENT_KINDS:
                ts = [t for t in tree_flatten(out)[0]
                      if isinstance(t, torch.Tensor)]
                nbytes = sum(t.numel() * t.element_size() for t in ts)
                self.events += [(name, nbytes)] * int(self.scale)
                if ts and all(t.dtype == torch.bfloat16 for t in ts):
                    self.bf16_events += [(name, nbytes)] * int(self.scale)
            return out

    return Recorder()


_ADDS = (torch.ops.aten.add.Tensor, torch.ops.aten.add_.Tensor)
_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)


def _refused(err: Exception) -> bool:
    """Whether ``err`` is DTensor's refusal of an op's shardings: no
    strategy registered for it, or none for these placements."""
    return isinstance(err, NotImplementedError) or (
        isinstance(err, RuntimeError)
        and "Sharding propagation failed" in str(err))


def _residual(a, b, *rest):
    """``a + b`` where one is a partial sum (a row-split product) and the
    other is not: the partial one reduced onto the other's placements
    first, so the residual stream keeps its layout (an all-reduce, or a
    reduce-scatter onto a split sequence), as XLA keeps the layout pinned
    on it.  DTensor left alone picks the cheapest placement for the sum,
    a sequence split on the model axis, and the next layer's batch x
    sequence flattening then merges two split dims."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return (a, b, *rest)
    pa = any(p.is_partial() for p in a.placements)
    pb = any(p.is_partial() for p in b.placements)
    if pa and not pb and a.shape == b.shape:
        a = a.redistribute(a.device_mesh, b.placements)
    elif pb and not pa and a.shape == b.shape:
        b = b.redistribute(b.device_mesh, a.placements)
    return (a, b, *rest)


def _flatten(t, shape, *rest):
    """A view that flattens an activation's (B, S, D) batch split and
    sequence split into one dim (the matmul of an ``sp`` layout's
    residual stream) gathers the sequence first, as Megatron's sequence
    parallelism gathers it before a column-split product: DTensor cannot
    express the merged split."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if (isinstance(t, DTensor) and t.ndim == 3 and len(shape) == 2
            and shape[0] == t.shape[0] * t.shape[1]
            and Shard(0) in t.placements and Shard(1) in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p == Shard(1) else p for p in t.placements])
    return (t, shape, *rest)


def _make_tracker(dmesh, recorder):
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._python_dispatch import TorchDispatchMode

    def placed(func, out):
        """``out`` as the next op can take it: a gather's masked partial
        result reduced now (DTensor's ``MaskPartial``, the all-reduce
        of a vocab-split embedding lookup, reduces only an embedding's
        2-D shape and fails on a gather's later).  A split of a split
        dim kept as a strided shard is refused: the card's torch 2.11
        refuses it outright, so rows do not depend on the version."""
        if not isinstance(out, DTensor):
            return out
        names = [type(p).__name__ for p in out.placements]
        if any("StridedShard" in n for n in names):
            raise UnshardableOp(f"{func}: a split of a sharded dim")
        if not any("MaskPartial" in n for n in names):
            return out
        return out.redistribute(dmesh, [
            Replicate() if "MaskPartial" in n else p
            for n, p in zip(names, out.placements)])

    class Tracker(TorchDispatchMode):
        """Above DTensor: an op whose shardings DTensor refuses ends the
        trace, naming the op; every op's allocations are tracked here,
        where DTensor's own shape propagation (on global shapes) and
        transient buffers are not seen."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in _ADDS:
                args = _residual(*args)
            elif func in _VIEWS:
                args = _flatten(*args)
            if not _is_dtensor_call(types):
                out = func(*args, **kwargs)
            else:
                try:
                    out = func(*args, **kwargs)
                except Exception as err:
                    if not _refused(err):
                        raise
                    first = str(err).strip().splitlines()
                    raise UnshardableOp(
                        f"{func}: {first[0] if first else type(err).__name__}"
                    ) from err
                out = placed(func, out)
            recorder.track(func, out)
            return out

    return Tracker()


def _make_lookups():
    from torch.distributed.tensor import DTensor
    from torch.overrides import TorchFunctionMode

    class Lookups(TorchFunctionMode):
        """Above autograd: a lookup of a table's rows by one index tensor
        (``embed[tokens]``) is the table's embedding, recorded as such
        for the backward.  DTensor gathers a row-split table whole to
        index it, and reduces its shards' masked lookups for an
        embedding."""

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if (func is torch.Tensor.__getitem__
                    and isinstance(args[0], DTensor) and args[0].ndim == 2
                    and isinstance(args[1], torch.Tensor)
                    and not args[1].is_floating_point()
                    and args[1].dtype != torch.bool):
                return torch.nn.functional.embedding(args[1], args[0])
            return func(*args, **(kwargs or {}))

    return Lookups()


# --------------------------------------------------------------------------
# the model's layout on the mesh
# --------------------------------------------------------------------------

def tp_config(cfg: ModelConfig, width: int) -> ModelConfig:
    """``cfg`` as a train or prefill step lays its attention out over a
    model axis of ``width``: query and KV heads that do not divide it are
    padded up to the next multiple of it that keeps the query heads a
    multiple of the KV heads (Mistral-NeMo-12B's 8 KV heads over 16 become
    16, each held by two devices beside the query heads that read it;
    Qwen1.5-32B's 40 become 48, three a device).  Every device then runs
    its own heads and the model axis carries only Megatron's reductions,
    which is nearer the reference's rows than gathering q / k / v over
    the axis for these long sequences.  A decode step keeps ``cfg``
    (``_gathered_heads``).  Values are never computed here, so padded
    heads only cost what they hold; other configs return as they are."""
    if cfg.use_mla or not _uneven_heads(cfg, width):
        return cfg
    kh = -(-cfg.n_kv_heads // width) * width if cfg.n_kv_heads > width \
        else width
    h = -(-cfg.n_heads // kh) * kh
    return dataclasses.replace(cfg, n_heads=h, n_kv_heads=kh)


def _gathered_heads(project):
    """``attention._project_qkv`` where the heads do not divide the model
    axis (a decode step of Qwen1.5-32B's 40 over 16 or Mistral-NeMo-12B's
    8 KV heads over 16; ``tp_config`` pads a train or prefill step's): the
    column-split products as the reference's specs split them, then q / k
    / v gathered over the model axis before the reshape into heads, which
    DTensor cannot split unevenly.  Attention then runs every head on
    each device's batch shard against a cache that ``fit_spec`` splits by
    sequence over the model axis (``_split_sequence_decode``), as the
    reference places it, and ``wo``'s row split takes each device's
    columns of the output back."""
    from torch.distributed.tensor import DTensor, Replicate

    def run(p, x, kv_x, cfg):
        mesh = getattr(x, "device_mesh", None)
        if (not isinstance(x, DTensor) or "model" not in mesh.mesh_dim_names
                or not _uneven_heads(cfg, mesh.size(
                    mesh.mesh_dim_names.index("model")))):
            return project(p, x, kv_x, cfg)
        ax = mesh.mesh_dim_names.index("model")

        def whole(t):
            return t.redistribute(mesh, [Replicate() if i == ax else pl
                                         for i, pl in enumerate(t.placements)])
        q, k, v = x @ p.wq, kv_x @ p.wk, kv_x @ p.wv
        if "bq" in p:
            q, k, v = q + p.bq, k + p.bk, v + p.bv
        b, sq = x.shape[:2]
        skv = kv_x.shape[1]
        return (whole(q).reshape(b, sq, cfg.n_heads, cfg.head_dim),
                whole(k).reshape(b, skv, cfg.n_kv_heads, cfg.head_dim),
                whole(v).reshape(b, skv, cfg.n_kv_heads, cfg.head_dim))
    return run


def _uneven_heads(cfg: ModelConfig, width: int) -> bool:
    """Whether ``cfg``'s query or KV heads do not divide a model axis of
    ``width`` (MLA splits its own heads)."""
    return not cfg.use_mla and bool(cfg.n_heads % width
                                    or cfg.n_kv_heads % width)


def _vocab_parallel_nll(nll):
    """``lm._nll`` of vocab-split DTensor logits, vocab-parallel as
    Megatron's: a max, a sum of exponentials and the masked gold sum,
    each reduced across the split onto the batch's placement.  DTensor's
    own ``logsumexp`` gathers the vocab, its gather's backward replicates
    the whole logits, and left to itself it scatters a reduction over the
    batch, which the backward then gathers back at vocab width."""
    from torch.distributed.tensor import DTensor, Replicate

    def reduced(t):
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])

    def run(logits, labels):
        if not isinstance(logits, DTensor):
            return nll(logits, labels)
        lf = logits.float()
        m = reduced(lf.amax(dim=-1, keepdim=True).detach())
        lse = torch.log(reduced(torch.exp(lf - m).sum(dim=-1))) + m[..., 0]
        ids = torch.arange(lf.shape[-1], device=lf.device)
        gold = reduced(torch.where(ids == labels.long()[..., None], lf,
                                   0.0).sum(dim=-1))
        return lse - gold
    return run


def _folded_flash(flash):
    """``attention._sdpa_flash`` with its query chunks folded where no
    autograd records: one chunk's pass (every kv chunk) counted once per
    chunk (``trace_cost.repeated``), the reference's ``length *
    cost(body)`` of a scan.  Every query chunk runs the same ops on the
    same shapes, so the count is the unfolded loop's (which takes minutes
    to trace at 32k positions) but for the softmax scale's 3 FLOPs, taken
    once per chunk; the output is the full one, unwritten."""
    def run(q, k, v, q_pos, kv_pos, causal, q_chunk, kv_chunk):
        n = q.shape[1] // q_chunk
        if n == 1 or not trace_cost.folding():
            return flash(q, k, v, q_pos, kv_pos, causal, q_chunk, kv_chunk)
        with trace_cost.repeated(n):
            out = flash(q[:, :q_chunk], k, v, q_pos[:, :q_chunk], kv_pos,
                        causal, q_chunk, kv_chunk)
        return out.new_empty((out.shape[0], q.shape[1]) + out.shape[2:])
    return run


def _local(t, mesh, placements, grad_placements=None):
    """A device's shard of ``t`` at ``placements`` (a plain tensor is
    taken as replicated), its gradient coming back at
    ``grad_placements`` (default: ``placements``)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, torch.Tensor):
        return t
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)


def _global(t, mesh, placements, shape):
    """The DTensor of ``shape`` whose local shard is ``t`` (made
    contiguous: DTensor takes the global strides as a contiguous
    tensor's, where a reshape copies a permuted one)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.contiguous(), mesh, placements,
                              run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _head_parallel(core):
    """An attention core (``attention._sdpa_dense`` / ``_sdpa_flash``:
    q (B, Sq, KH, G, Dh), k / v (B, Skv, KH, Dh)) on each device's shard
    of DTensor arguments: the batch and KV heads it holds, no collective.
    DTensor's own propagation refuses the core's einsums, whose batched
    product merges the split batch and head dims into one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def run(q, k, v, q_pos, kv_pos, *args, **kwargs):
        if not isinstance(q, DTensor):
            return core(q, k, v, q_pos, kv_pos, *args, **kwargs)
        mesh = q.device_mesh
        if any(p not in (Shard(0), Shard(2), Replicate())
               for p in q.placements):
            raise UnshardableOp(f"attention core: query placements "
                                f"{q.placements}, neither batch nor heads")
        pl = list(q.placements)
        rows = [p if p == Shard(0) else Replicate() for p in pl]

        def loc(t, placements=rows):               # kv_len: (B,)
            return _local(t, mesh, placements)
        out = core(loc(q, pl), loc(k, pl), loc(v, pl), loc(q_pos),
                   loc(kv_pos), *map(loc, args),
                   **{n: loc(t) for n, t in kwargs.items()})
        return _global(out, mesh, pl, q.shape[:4] + out.shape[4:])
    return run


def _split_sequence_decode(attend):
    """``attention._attend_cache`` on a KV cache split by sequence (a
    batch-1 cache over the data axis): each device writes the step's row
    into its own positions (in the trace, the row at its offset of the
    step's index) and attends to its positions, and the shards combine as
    split-sequence flash-decoding does: an all-reduce of the rows' maxima
    and one of their sums, then the rescaled outputs summed (left
    partial: the sum is linear, and the row-split ``wo`` product after it
    reduces with it).  DTensor's own slice of the split sequence gathers
    the cache whole to write one row."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def run(q, k, v, cache, cache_index, cfg, positions):
        ck = cache["k"]
        if not (isinstance(ck, DTensor) and Shard(1) in ck.placements):
            return attend(q, k, v, cache, cache_index, cfg, positions)
        mesh = ck.device_mesh
        seq = [p == Shard(1) for p in ck.placements]
        if any(s and p != Replicate() for s, p in zip(seq, q.placements)):
            raise UnshardableOp("attention: a sequence-split cache under "
                                "split queries")
        pl = [Replicate() if s else p for s, p in zip(seq, ck.placements)]
        heads = 1                                  # the KV heads' split
        for i, p in enumerate(ck.placements):
            heads *= mesh.size(i) if p == Shard(2) else 1
        local_cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // heads,
                                        n_kv_heads=cfg.n_kv_heads // heads)
        local_cache = {n: t.to_local() for n, t in cache.items()}
        span = local_cache["k"].shape[1]
        # positions: (B, Sq), or M-RoPE's (3, B, Sq): split by batch
        rows = [Shard(positions.ndim - 2) if p == Shard(0) else Replicate()
                for p in pl]
        out = attend(_local(q, mesh, pl), _local(k, mesh, pl),
                     _local(v, mesh, pl), local_cache, cache_index % span,
                     local_cfg, _local(positions, mesh, rows))
        b, sq = q.shape[:2]
        shape = (b, sq, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                 out.shape[-1])
        for op in ("max", "sum"):                  # each row's, float32
            _global(out.new_empty(out.shape[:4], dtype=torch.float32),
                    mesh, [Partial(op) if s else p
                           for s, p in zip(seq, pl)],
                    shape[:4]).redistribute(mesh, pl)
        return _global(out, mesh, [Partial() if s else p
                                   for s, p in zip(seq, pl)], shape)
    return run


def _grad_partial(placements):
    """Where a local function's input is replicated, each device's
    gradient is its share of the whole: partial."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if isinstance(p, Replicate) else p for p in placements]


def _model_axis_local(block, mesh, ax):
    """``block``'s weights as a ``Block`` of local shards: each at its own
    placement on the model axis ``ax`` and replicated on the others."""
    from torch.distributed.tensor import Replicate
    tensors = {}
    for name, t in [*block.named_parameters(), *block.named_buffers()]:
        pl = [t.placements[ax] if i == ax else Replicate()
              for i in range(mesh.ndim)]
        tensors[name] = _local(t, mesh, pl, _grad_partial(pl))
    return lm.Block(tensors, view=True)


def _head_parallel_mla(mla):
    """``attention.mla_attention`` on DTensor arguments as Megatron's
    tensor parallelism: each device runs its heads (its columns of
    ``wq`` and ``wkv_b``, its rows of ``wo``) on its batch shard, the
    latent projection replicated, and its output is a partial sum over
    the model axis.  DTensor's own propagation of the prefill's einsums
    gathers the (B, H, S, S) scores whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def run(p, x, cfg, *, positions, cache=None, cache_index=None):
        if not isinstance(x, DTensor):
            return mla(p, x, cfg, positions=positions, cache=cache,
                       cache_index=cache_index)
        mesh = x.device_mesh
        ax = mesh.mesh_dim_names.index("model")
        width = mesh.size(ax)
        if (cfg.n_heads % width or p.wo.placements[ax] != Shard(0)
                or any(pl not in (Shard(0), Replicate())
                       for i, pl in enumerate(x.placements) if i != ax)):
            raise UnshardableOp("mla_attention: heads not split over the "
                                "model axis, or the batch split otherwise")
        x_pl = [Replicate() if i == ax else pl
                for i, pl in enumerate(x.placements)]
        rows = [Shard(0) if pl == Shard(0) else Replicate() for pl in x_pl]
        local_cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // width,
                                        n_kv_heads=cfg.n_heads // width)
        local_cache = None if cache is None else {
            n: _local(t, mesh, rows) for n, t in cache.items()}
        out, new = mla(_model_axis_local(p, mesh, ax),
                       _local(x, mesh, x_pl, _grad_partial(x_pl)), local_cfg,
                       positions=_local(positions, mesh, rows),
                       cache=local_cache, cache_index=cache_index)
        out = _global(out, mesh, [Partial() if i == ax else pl
                                  for i, pl in enumerate(x_pl)], x.shape)
        if cache is not None:
            return out, cache              # its local shards written in place
        return out, {n: _global(t, mesh, rows, x.shape[:2] + t.shape[2:])
                     for n, t in new.items()}
    return run


def _head_parallel_ssm(ssm_layer):
    """``ssm.ssm_layer`` on DTensor arguments as the reference's specs
    lay a Mamba2 layer out: each device runs its heads (its columns of
    ``w_z`` / ``w_x`` / ``w_dt`` and the convolution, its rows of
    ``out_proj``; B and C replicated) on its batch shard, its state's
    heads in place, and its output is a partial sum over the model axis.
    The gated norm takes its statistics over the device's channels, as
    Mamba2's grouped norm does under tensor parallelism: the (B, S)
    reduction of a whole-width norm is not counted.  DTensor's own
    propagation refuses the layer's batched products, which merge the
    split batch and head dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def run(p, x, cfg, *, state=None):
        if not isinstance(x, DTensor):
            return ssm_layer(p, x, cfg, state=state)
        mesh = x.device_mesh
        ax = mesh.mesh_dim_names.index("model")
        width = mesh.size(ax)
        if (cfg.d_model % width or cfg.ssm_nheads % width
                or p.out_proj.placements[ax] != Shard(0)
                or any(pl not in (Shard(0), Replicate())
                       for i, pl in enumerate(x.placements) if i != ax)):
            raise UnshardableOp("ssm_layer: heads not split over the model "
                                "axis, or the batch split otherwise")
        x_pl = [Replicate() if i == ax else pl
                for i, pl in enumerate(x.placements)]
        rows = [Shard(0) if pl == Shard(0) else Replicate() for pl in x_pl]
        # d_inner = ssm_expand * d_model: the device's share of the heads
        local_cfg = dataclasses.replace(cfg, d_model=cfg.d_model // width)
        split = {"ssm": Shard(1), "conv_x": Shard(2), "conv_bc": Replicate()}

        def placed(name):
            return [split[name] if i == ax else pl
                    for i, pl in enumerate(rows)]
        local_state = None if state is None else {
            n: _local(t, mesh, placed(n)) for n, t in state.items()}
        out, new = ssm_layer(_model_axis_local(p, mesh, ax),
                             _local(x, mesh, x_pl, _grad_partial(x_pl)),
                             local_cfg, state=local_state)
        out = _global(out, mesh, [Partial() if i == ax else pl
                                  for i, pl in enumerate(x_pl)], x.shape)
        b = x.shape[0]
        shapes = {"ssm": (b, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
                  "conv_x": (b, cfg.ssm_conv - 1, cfg.d_inner),
                  "conv_bc": (b, cfg.ssm_conv - 1,
                              2 * cfg.ssm_ngroups * cfg.ssm_state)}
        return out, {n: _global(t, mesh, placed(n), shapes[n])
                     for n, t in new.items()}
    return run


def _expert_parallel(moe_ffn):
    """``lm.moe_ffn`` on DTensor arguments as expert parallelism over the
    model axis: each device routes every token of its batch shard (the
    router replicated), runs its own experts' buffers and its columns of
    the shared experts, and its output is a partial sum over the model
    axis, reduced where the residual stream needs it: what XLA makes of
    the reference's one-hot dispatch and combine einsums with the experts
    split.  A device groups its own tokens (at decode its batch shard is
    one group, where the reference's one group is the whole batch).
    DTensor refuses the port's scatter into the buffers."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..models import moe

    def run(p, x, cfg, group_size=2048):
        if not isinstance(x, DTensor):
            return moe_ffn(p, x, cfg, group_size)
        mesh = x.device_mesh
        ax = mesh.mesh_dim_names.index("model")
        if p.w_gate.placements[ax] != Shard(0) or any(
                pl not in (Shard(0), Replicate())
                for i, pl in enumerate(x.placements) if i != ax):
            raise UnshardableOp("moe_ffn: experts not split over the "
                                "model axis, or the batch split otherwise")

        x_pl = [Replicate() if i == ax else pl
                for i, pl in enumerate(x.placements)]
        xl = _local(x, mesh, x_pl, _grad_partial(x_pl))
        pl_local = _model_axis_local(p, mesh, ax)
        r = moe.dispatch(pl_local, xl, cfg, group_size)
        n_local = pl_local.w_gate.shape[0]
        e0 = mesh.get_local_rank(ax) * n_local
        y = r.xe.new_zeros(r.xe.shape)
        y[:, e0:e0 + n_local] = moe.expert_ffn(pl_local,
                                               r.xe[:, e0:e0 + n_local])
        out, aux = moe.combine(pl_local, r, y, cfg, xl.shape)
        out_pl = [Partial() if i == ax else pl for i, pl in enumerate(x_pl)]
        aux_pl = [Replicate() if i == ax or isinstance(pl, Replicate)
                  else Partial("avg") for i, pl in enumerate(x_pl)]
        return (_global(out, mesh, out_pl, x.shape),
                {n: _global(a, mesh, aux_pl, ()) for n, a in aux.items()})
    return run


@contextlib.contextmanager
def traced_model():
    """The model functions the dry run traces in place of the port's own
    while it is active: ``_gathered_heads``, ``_vocab_parallel_nll``,
    ``_folded_flash``, ``_head_parallel`` attention cores,
    ``_split_sequence_decode``, ``_head_parallel_mla``,
    ``_head_parallel_ssm`` and ``_expert_parallel`` MoE layers.  On plain
    tensors each computes what the function it stands for does."""
    from ..models import attention
    saved = (lm._nll, lm.moe_ffn, lm.ssm_layer, attention._sdpa_flash,
             attention._sdpa_dense, attention.mla_attention,
             attention._attend_cache, attention._project_qkv)
    attention._project_qkv = _gathered_heads(saved[7])
    lm._nll = _vocab_parallel_nll(saved[0])
    lm.moe_ffn = _expert_parallel(saved[1])
    lm.ssm_layer = _head_parallel_ssm(saved[2])
    attention._sdpa_flash = _head_parallel(_folded_flash(saved[3]))
    attention._sdpa_dense = _head_parallel(saved[4])
    attention.mla_attention = _head_parallel_mla(saved[5])
    attention._attend_cache = _split_sequence_decode(saved[6])
    try:
        yield
    finally:
        (lm._nll, lm.moe_ffn, lm.ssm_layer, attention._sdpa_flash,
         attention._sdpa_dense, attention.mla_attention,
         attention._attend_cache, attention._project_qkv) = saved


@dataclasses.dataclass
class ShardedTrace:
    """What one sharded run of a step recorded, per device."""

    events: List[Tuple[str, int]]
    arguments: int
    output: int
    temp: int
    bf16_events: List[Tuple[str, int]]


def _local_bytes(obj: Any) -> int:
    from torch.distributed.tensor import DTensor
    seen, total = set(), 0
    for t in tensors_of(obj):
        local = t.to_local() if isinstance(t, DTensor) else t
        if id(t) not in seen:
            seen.add(id(t))
            total += local.numel() * local.element_size()
    return total


@contextlib.contextmanager
def _all_to_all():
    """DTensor's move of a split from one dim to another as the
    all-to-all a card's process group runs: on a CPU mesh DTensor
    gathers the whole tensor and keeps its chunk instead, which would be
    counted as an all-gather of the whole."""
    from torch.distributed.tensor import placement_types
    op = getattr(torch.ops._dtensor, "shard_dim_alltoall", None)
    saved = getattr(placement_types, "shard_dim_alltoall", None)
    if op is None or saved is None:
        yield
        return

    def all_to_all(x, gather_dim, shard_dim, mesh, mesh_dim):
        return op(x, gather_dim, shard_dim,
                  mesh.get_group(mesh_dim).group_name)
    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = saved


def trace_sharded(fn, args: tuple, dmesh, out_specs: Any = None
                  ) -> Tuple[Any, ShardedTrace]:
    """Run ``fn(*args)`` (DTensor arguments) once; return its output,
    redistributed to ``out_specs`` (a tree of specs, None: as it comes),
    and what the run recorded."""
    from torch.distributed.tensor.experimental import implicit_replication
    recorder = _make_recorder()
    with implicit_replication(), _all_to_all(), _make_lookups(), recorder, \
            _make_tracker(dmesh, recorder):
        out = fn(*args)
        if out_specs is not None:
            out = tuple(_redistribute(o, s, dmesh)
                        for o, s in zip(out, out_specs))
    return out, ShardedTrace(
        events=recorder.events, arguments=_local_bytes(args),
        output=_local_bytes(out), temp=recorder.peak,
        bf16_events=recorder.bf16_events)


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------

def _bf16_params(params: lm.LM) -> lm.LM:
    return lm.LM(params.cfg, {
        n: (torch.empty(t.shape, dtype=torch.bfloat16, device="meta")
            if t.dtype == torch.float32 else t)
        for n, t in params.named_parameters()})


def _build(cfg: ModelConfig, cell: Cell, opts: dict, pmesh,
           dmesh=None) -> Tuple[Any, tuple, Any]:
    """(step, args, out specs) of ``cell``: args on meta, or with
    ``dmesh`` DTensors placed by the reference's specs on ``pmesh``, a
    train or prefill step's heads laid out by ``tp_config``."""
    dp = ("pod", "data") if "pod" in pmesh.axis_names else "data"
    if dmesh is not None and cell.kind != "decode":
        cfg = tp_config(cfg, pmesh.shape["model"])
    params = lm.abstract_params(cfg)
    if cell.kind == "decode" and opts.get("params_dtype") == "bf16":
        params = _bf16_params(params)      # serve from bfloat16 weights
    # the serving steps cast float32 weights on their first call, inside
    # the trace, as the reference casts each at its product
    p_specs = rules.param_pspecs(params, pmesh)
    opt_specs = (rules.zero1_pspecs(params, pmesh) if opts.get("zero1")
                 else p_specs)
    vspec = "model" if cfg.vocab_padded % pmesh.shape["model"] == 0 else None

    def put(tree, specs):
        return tree if dmesh is None else distribute(tree, specs, dmesh)

    if cell.kind == "train":
        bf16 = opts.get("params_dtype") == "bf16"
        if bf16:
            params = _bf16_params(params)
        opt = AdamW(master_weights=bf16)
        batch = steps.input_specs(cfg, cell)
        b_specs = rules.input_pspecs(cfg, pmesh, "train")
        # no layout: the residual stream split by batch and whole over the
        # model axis, the Megatron layout XLA's propagation reaches from
        # the weight specs; DTensor's op-by-op choice would wander off it
        act = (dp, None, None)
        if opts.get("layout") == "fsdp":
            # ZeRO-3: weights over the flattened mesh, the batch over every
            # axis, weights gathered per layer
            axes = tuple(pmesh.axis_names)
            p_specs = opt_specs = rules.fsdp_pspecs(params, pmesh)
            act = (axes, None, None)
            b_specs = {k: (axes,) + (None,) * (v.ndim - 1)
                       for k, v in batch.items()}
        elif opts.get("layout") == "sp":
            act = (dp, "model", None)
        zeros = lm.LM(cfg, {n: torch.empty(t.shape, device="meta")
                            for n, t in params.named_parameters()})
        state = AdamWState(torch.zeros((), dtype=torch.int32, device="meta"),
                           zeros, zeros, zeros if bf16 else None)
        act_spec = None
        if act is not None and dmesh is not None:
            def act_spec(h, act=act):
                return _redistribute(h, act, dmesh)
        step = steps.make_train_step(
            cfg, opt, remat_policy=opts.get("remat_policy"),
            grad_compress=opts.get("grad_compress"), act_spec=act_spec,
            loss_chunks=opts.get("loss_chunks", 0),
            cast_params=opts.get("cast_params", False),
            remat=not opts.get("no_remat", False))
        s_specs = AdamWState((), opt_specs, opt_specs,
                             opt_specs if bf16 else None)
        args = (put(params, p_specs), put(state, s_specs), put(batch, b_specs))
        return step, args, None if dmesh is None else (None, None, None)
    if cell.kind == "prefill":
        batch = steps.input_specs(cfg, cell)
        b_specs = rules.input_pspecs(cfg, pmesh, "prefill")
        caches = lm.init_caches(cfg, cell.global_batch, cell.seq,
                                device="meta")
        c_specs = rules.cache_pspecs(cfg, pmesh, caches)
        step = steps.make_prefill_step(cfg)
        return (step, (put(params, p_specs), put(batch, b_specs)),
                ((dp, None, vspec), c_specs))
    seq_shard = cell.global_batch == 1
    tokens, caches, _ = steps.decode_input_specs(
        cfg, cell, cache_dtype=_DTYPES[opts.get("kv_dtype") or "bf16"])
    c_specs = rules.cache_pspecs(cfg, pmesh, caches, seq_shard=seq_shard)
    tok_spec = (None, None) if seq_shard else (dp, None)
    step = steps.make_decode_step(cfg)
    args = (put(params, p_specs), put(tokens, tok_spec), put(caches, c_specs),
            cell.seq - 1)
    return step, args, ((None if seq_shard else dp, None, vspec), c_specs)


def trace_cell(cfg: ModelConfig, cell: Cell, *, multi_pod: bool = False,
               opts: Optional[dict] = None,
               hw: HardwareSpec = H100_SXM, mesh: Optional[Mesh] = None
               ) -> dict:
    """The dry run of one (config, cell): the global cost, the sharded
    trace on the production mesh (or ``mesh``: a reduced config's heads
    split over a narrower model axis), the roofline terms.  A row of the
    reference's fields (less ``arch`` / ``cell`` / ``mesh`` / ``tag``),
    plus ``hw``."""
    opts = dict(opts or {})
    if opts.get("capacity_factor"):
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=opts["capacity_factor"])
    pmesh = mesh or make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    with traced_model():
        step, args, _ = _build(cfg, cell, opts, pmesh)
        jc = program_cost(step, *args)             # global analytic cost
        dmesh = device_mesh(tuple(pmesh.shape.values()), pmesh.axis_names)
        step, args, out_specs = _build(cfg, cell, opts, pmesh, dmesh)
        _, tr = trace_sharded(step, args, dmesh, out_specs)
    t1 = time.time()
    chips = pmesh.size
    stats = collective_stats(tr.events)
    coll_per_dev = stats.total_bytes
    peak = dense_peak(hw, "bfloat16")
    t_compute = jc["flops"] / (chips * peak)
    t_memory = jc["bytes"] / (chips * hw.mem_bw)
    t_collective = coll_per_dev / hw.link_bw
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)
    t_bound = max(terms.values())
    mf = steps.model_flops(cfg, cell)
    return {
        "chips": chips,
        "lower_compile_s": round(t1 - t0, 1),
        "bytes_per_device": {
            "arguments": tr.arguments,
            "output": tr.output,
            "temp": tr.temp,
            "total_gb": round((tr.arguments + tr.output + tr.temp) / 2**30,
                              3),
        },
        "hlo_flops": jc["flops"], "dot_flops": jc["dot_flops"],
        "hlo_bytes": jc["bytes"],
        "coll_bytes_per_dev": coll_per_dev,
        "collectives": {"bytes_by_kind": stats.bytes_by_kind,
                        "count_by_kind": stats.count_by_kind,
                        "bf16_bytes_by_kind": collective_stats(
                            tr.bf16_events).bytes_by_kind},
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_collective, "dominant": dominant,
        "t_bound_s": t_bound,
        "model_flops": mf,
        "useful_ratio": mf / jc["flops"] if jc["flops"] else None,
        "mfu_bound": mf / (t_bound * chips * peak) if t_bound else None,
        "xla_cost_flops_per_dev_loops_once": None,
        "opts": opts,
        "hw": hw.name,
    }


def lower_cell(arch: str, cell_name: str, *, multi_pod: bool = False,
               opts: Optional[dict] = None, hw: HardwareSpec = H100_SXM,
               cfg: Optional[ModelConfig] = None,
               mesh: Optional[Mesh] = None):
    """The dry run of one cell, as the reference's ``lower_cell``:
    ``(None, step, meta)``, where the reference returns its compiled
    program first (there is none here); ``meta`` is ``{"skipped":
    reason}`` for a cell the arch does not run.  ``cfg`` replaces
    ``get_arch(arch)`` (a reduced config), ``mesh`` the production
    mesh."""
    cfg = cfg or get_arch(arch)
    cell = CELLS[cell_name]
    ok, reason = applicable(cfg, cell)
    if not ok:
        return None, None, {"skipped": reason}
    meta = trace_cell(cfg, cell, multi_pod=multi_pod, opts=opts, hw=hw,
                      mesh=mesh)
    name = ("x".join(str(n) for n in mesh.shape.values()) if mesh
            else "2x16x16" if multi_pod else "16x16")
    return None, None, {"arch": arch, "cell": cell_name, "mesh": name,
                        **meta}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--cell", choices=sorted(CELLS), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--grad-compress", default=None)
    ap.add_argument("--layout", default=None, choices=(None, "fsdp", "sp"))
    ap.add_argument("--loss-chunks", type=int, default=0)
    ap.add_argument("--kv-dtype", default=None, choices=(None, "int8", "bf16"))
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--cast-params", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--params-dtype", default=None, choices=(None, "bf16"))
    ap.add_argument("--tag", default=None, help="label for this opts combo")
    ap.add_argument("--hw", default="h100",
                    help="platform of the terms: h100 (SXM5), v5e, ...")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.cell):
        ap.error("give --arch and --cell, or --all")
    LOG.configure(level="info")   # launcher mains narrate by default
    hw = get_platform(args.hw)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = {}
    if out.exists():
        rows = {f"{r['arch']}/{r['cell']}/{r['mesh']}"
                + (f"/{r['tag']}" if r.get("tag") else ""): r
                for r in json.loads(out.read_text())}

    pairs = ([(args.arch, args.cell)] if not args.all else
             [(a, c) for a in sorted(ARCHS) for c in sorted(CELLS)])
    meshes = [False, True] if args.both_meshes else [args.multipod]
    opts = {k: getattr(args, k.replace("-", "_")) for k in
            ("zero1", "remat_policy", "grad_compress", "layout",
             "loss_chunks", "kv_dtype", "capacity_factor", "cast_params",
             "params_dtype", "no_remat") if getattr(
                args, k.replace("-", "_"))}

    tag = f"/{args.tag}" if args.tag else ""
    for multi_pod in meshes:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        for arch, cell in pairs:
            key = f"{arch}/{cell}/{mesh_name}{tag}"
            if key in rows and not args.force:
                LOG.info("skip-cached", cell=key)
                continue
            LOG.info("trace", cell=key)
            try:
                _, _, meta = lower_cell(arch, cell, multi_pod=multi_pod,
                                        opts=opts, hw=hw)
            except Exception as e:  # a failure here is a sharding fault
                traceback.print_exc()
                LOG.error("trace failed", cell=key,
                          error=f"{type(e).__name__}: {e}")
                meta = {"arch": arch, "cell": cell, "mesh": mesh_name,
                        "tag": args.tag,
                        "error": f"{type(e).__name__}: {e}"}
                rows[key] = meta
                out.write_text(json.dumps(list(rows.values()), indent=1,
                                          default=str))
                continue
            meta["tag"] = args.tag
            if "skipped" in meta:
                meta = {"arch": arch, "cell": cell, "mesh": mesh_name,
                        "tag": args.tag, "skipped": meta["skipped"]}
                LOG.info("cell skipped", cell=key, reason=meta["skipped"])
            else:
                LOG.info(
                    "cell ok", cell=key,
                    gib_per_dev=meta["bytes_per_device"]["total_gb"],
                    dominant=meta["dominant"],
                    t_bound_s=round(meta["t_bound_s"], 4),
                    trace_s=meta["lower_compile_s"])
            rows[key] = meta
            out.write_text(json.dumps(list(rows.values()), indent=1,
                                      default=str))
    print(f"wrote {out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
