"""Padding-aware batch execution of kernel requests via the dispatcher.

The executor behind the continuous-batching scheduler for registered
kernel families: a formed batch of same-(kernel, dtype) requests is
**packed** into one launch of the hand-written elementwise kernel when
the family is elementwise (its call arguments are scalars plus
same-length 1-D tensors: SCALE, STREAM Triad, AXPY), by concatenating
each tensor argument across requests on the device and zero-padding to
a *fixed capacity* derived from the policy's ``max_batch`` and the
dispatch layer's tile shape (``block_rows x lanes``: the tuned one when
the dispatcher's cache holds one, else the static default).  Fixed-capacity
packing keeps every launch of a (kernel, dtype, engine) triple at one
shape, and engine selection is the dispatcher's memoized Advice (paper
§6): a dict hit, not a roofline re-derivation, as the paper's
steady-state argument requires.  The launch goes through the registry's
``EngineOp`` (``op(*packed, engine=..., backend=...)``), so the
elementwise wrapper's own signature never meets the batcher.

Families whose inputs do not pack (SpMV's block-ELL operands, stencil
grids, attention caches) fall back to per-request execution inside the
batch: still amortizing Advice memoization and input construction, just
not the launch itself.

**Timing.**  ``compute_s`` is the completed time of the launch: on the
card the executor synchronizes before the clock starts and after the
call returns, so the host's enqueue alone is never what is measured.
The first launch of each shape runs untimed (the warm-up), so the first
batch does not carry one-off costs.  Packing runs before the clock
starts.

Under a mesh (``num_shards > 1``) the packed launch splits shard-wise
via :mod:`repro_torch.sharding`: the packed capacity rounds up to whole
tiles *per shard*, each shard launches through the dispatcher (same
memoized Advice, same tuned tiles), one after another on the executor's
device, and the batch is charged the **shard-parallel** compute time --
the slowest shard, which is what an N-device mesh would fold into the
virtual clock.  The per-request fallback shards each request the same
way.

``backend`` is the reference's ``interpret``: ``"cuda"`` (the default)
launches the hand-written kernels on tensors on the card, ``"plain"``
runs their plain PyTorch versions on the CPU.  ``real_mesh=True`` runs
each sharded launch on ``num_shards`` ranks at once instead
(:class:`~repro_torch.sharding.executor.MeshExecutor`, after
``repro_torch.launch.mesh.host_device_count``): the batch is charged the
**measured** mesh wall (exchange and all) rather than the modelled
slowest shard.
"""
from __future__ import annotations

import numbers
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.dispatch import (BACKENDS, DEFAULT_DISPATCHER,
                             ELEMENTWISE_BLOCK_ROWS, ELEMENTWISE_LANES,
                             normalize_engine)
from ..kernels import registry
from ..models.engine import resolve_device
from ..sharding import MeshExecutor, ShardedExecutor
from .requests import Request
from .scheduler import BatchExecution

__all__ = ["KernelBatchExecutor"]


def _is_scalar(a) -> bool:
    """A Python number or a 0-d tensor: rides along from the template."""
    if isinstance(a, torch.Tensor):
        return a.ndim == 0
    return isinstance(a, numbers.Number)


class KernelBatchExecutor:
    """Execute formed batches of registry-kernel requests.

    ``engine`` is the session-wide flag: ``'auto'`` defers to the
    memoized Advice (§6 routing: memory-bound work lands on the vector
    engine), ``'vpu'``/``'mxu'`` force a variant so the benchmark can
    measure both sides of the paper's question under load.
    ``num_shards > 1`` splits every launch via ``repro_torch.sharding``
    and charges batches the shard-parallel (max) compute time;
    ``real_mesh=True`` runs the split on ranks and charges the measured
    mesh wall.
    """

    def __init__(self, engine: str = "auto", *, max_batch: int = 8,
                 backend: str = "cuda", seed: int = 0,
                 num_shards: int = 1, real_mesh: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected "
                             f"{BACKENDS}")
        self.engine = engine
        self.max_batch = max_batch
        self.backend = backend
        self.device = resolve_device("cuda" if backend == "cuda" else "cpu")
        self.num_shards = max(1, int(num_shards))
        self.real_mesh = bool(real_mesh) and self.num_shards > 1
        if self.real_mesh:
            # the virtual executor's plan() / run(...).parallel_s surface,
            # so the packed and per-request paths below are the same
            self._shard_exec = MeshExecutor(self.num_shards, backend=backend)
        else:
            self._shard_exec = (ShardedExecutor(self.num_shards,
                                                backend=backend)
                                if self.num_shards > 1 else None)
        self._rng = np.random.default_rng(seed)
        # (kernel, size, dtype) -> canonical (args, kwargs): request
        # payloads are synthetic, so one input per shape is reused --
        # values never move a kernel on the roofline
        self._inputs: Dict[Tuple[str, int, str], Tuple[tuple, dict]] = {}
        # shape key -> ShardPlan: the split is a pure function of the
        # launch shape, so steady-state sharded serving replans nothing
        self._plans: Dict[Tuple, object] = {}
        self._warmed: set = set()

    # -- inputs ------------------------------------------------------------

    def _canonical(self, kernel: str, size: int, dtype: str):
        key = (kernel, size, dtype)
        if key not in self._inputs:
            op = registry.get(kernel)
            self._inputs[key] = op.make_inputs(self._rng, size, dtype,
                                               self.device)
        return self._inputs[key]

    def use_inputs(self, kernel: str, size: int, dtype: str, args: tuple,
                   kwargs: dict) -> None:
        """Serve requests of (kernel, size, dtype) on these call arguments
        instead of ``make_inputs(rng, size, ...)``: for inputs that
        ``size`` alone does not describe, such as a decode shape with
        more heads than ``make_inputs`` builds."""
        self._inputs[(kernel, size, dtype)] = (tuple(args), dict(kwargs))

    @staticmethod
    def _packable(args: tuple, kwargs: dict, size: int) -> bool:
        """True iff every call argument is a scalar or a size-long 1-D
        tensor (the elementwise shape the packed launch takes)."""
        if kwargs:
            return False
        saw_array = False
        for a in args:
            if _is_scalar(a):
                continue
            if not isinstance(a, torch.Tensor) or tuple(a.shape) != (size,):
                return False
            saw_array = True
        return saw_array

    def _capacity(self, kernel: str, engine: str, total: int,
                  dtype: str) -> int:
        """Packed length: max_batch x per-request size, tile-rounded.

        Uses the tile shape dispatch would launch with (the tuned
        ``block_rows`` / ``lanes`` when the default dispatcher's cache
        holds them, the static 256 x 1024 otherwise), as the reference
        does.  The elementwise kernel's launch does not depend on this
        tile (one 16-byte chunk per thread, see ``elementwise_call``):
        the padding follows the reference, so that the packed shapes are
        its shapes.  Under a mesh the unit is ``num_shards`` tiles, so the
        packed array splits into equal per-shard ranges of whole tiles.
        """
        entry = DEFAULT_DISPATCHER.tuning.lookup(
            kernel, engine, dtype, DEFAULT_DISPATCHER.hw.name,
            num_shards=self.num_shards)
        cfg = dict(entry.params) if entry is not None else {}
        tile = (cfg.get("block_rows", ELEMENTWISE_BLOCK_ROWS)
                * cfg.get("lanes", ELEMENTWISE_LANES)) * self.num_shards
        cap = max(total, 1)
        return -(-cap // tile) * tile  # ceil to a whole tile count

    def _tile_override(self, op, engine: str, dtype: str):
        """Per-launch tile-config override hook (None = dispatch decides).

        The base executor never overrides: tuned tiles come from the
        dispatcher's TuningPolicy.  The online-tuning executor
        (:class:`repro_torch.serving.router.OnlineKernelBatchExecutor`)
        overrides it to inject the bandit's current arm into packed
        launches.
        """
        del op, engine, dtype
        return None

    def _resolve_engine(self, op, args, kwargs) -> Tuple[str, str]:
        """(engine to run, what 'auto' would pick) via memoized Advice."""
        auto = op.advice(*args, **kwargs).engine
        forced = normalize_engine(self.engine)
        return (auto if forced is None else forced), auto

    def advice_for(self, kernel: str, size: int, dtype: str):
        """The memoized single-request Advice (metrics/record fields)."""
        op = registry.get(kernel)
        args, kwargs = self._canonical(kernel, size, dtype)
        return op.advice(*args, **kwargs)

    # -- execution ---------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, warm_key: Tuple, launch) -> float:
        """Seconds of one completed ``launch()``, after an untimed first
        launch per ``warm_key``; the card is idle when the clock starts."""
        if warm_key not in self._warmed:
            launch()
            self._warmed.add(warm_key)
        self._sync()
        t0 = time.perf_counter()
        launch()
        self._sync()
        return time.perf_counter() - t0

    def _sharded_compute(self, op, args: tuple, kwargs: dict,
                         engine: str, plan_key: Tuple,
                         warm_key: Tuple) -> float:
        """One shard-parallel launch: cached plan, warmed, timed.

        The shared mesh path behind both the packed and the per-request
        launches: the ShardPlan is a pure function of the launch shape
        (cached under *plan_key*), the first launch of a shape warms
        outside the timed region, and the batch is charged the slowest
        shard (``parallel_s``; each shard's clock runs between two
        synchronizations).
        """
        plan = self._plans.get(plan_key)
        if plan is None:
            plan = self._plans[plan_key] = \
                self._shard_exec.plan(op, *args, **kwargs)
        if warm_key not in self._warmed:
            self._shard_exec.run(op, *args, engine=engine, plan=plan,
                                 **kwargs)
            self._warmed.add(warm_key)
        return self._shard_exec.run(op, *args, engine=engine, plan=plan,
                                    **kwargs).parallel_s

    def _pack(self, op, batch: Sequence[Request],
              engine: str) -> Tuple[List, int]:
        """(packed call arguments, capacity) for one formed batch."""
        dtype = batch[0].dtype
        per_req = [self._canonical(op.name, r.size, dtype) for r in batch]
        # capacity covers max_batch full-size requests (the stable launch
        # shape) but never less than this batch actually holds, so a
        # scheduler policy with a larger max_batch than ours costs one
        # more launch shape instead of a crash
        total = sum(r.size for r in batch)
        cap = self._capacity(op.name, engine,
                             max(self.max_batch * max(r.size for r in batch),
                                 total), dtype)
        packed = []
        for i, a in enumerate(per_req[0][0]):
            if _is_scalar(a):
                packed.append(a)  # scalars ride along from the template
                continue
            parts = [args[i] for args, _ in per_req]
            pad = cap - total
            if pad:
                parts.append(a.new_zeros(pad))
            packed.append(torch.cat(parts))
        return packed, cap

    def packed_call(self, batch: Sequence[Request]
                    ) -> Tuple[torch.Tensor, List[int]]:
        """One untimed packed launch of a formed elementwise batch (split
        across the shards under a mesh).

        Returns the capacity-long output and each request's length in
        batch order: request i's result is the slice starting at the sum
        of the lengths before it.
        """
        op = registry.get(batch[0].kernel)
        args, kwargs = self._canonical(op.name, batch[0].size,
                                       batch[0].dtype)
        if not self._packable(args, kwargs, batch[0].size):
            raise ValueError(f"kernel {op.name!r} does not pack")
        engine, _ = self._resolve_engine(op, args, kwargs)
        packed, _ = self._pack(op, batch, engine)
        if self._shard_exec is not None:
            out = self._shard_exec.run(op, *packed, engine=engine).out
        else:
            out = op(*packed, engine=engine, backend=self.backend)
        return out, [r.size for r in batch]

    def _run_packed(self, op, batch: Sequence[Request],
                    engine: str) -> float:
        """One fused launch over the concatenated + padded batch."""
        dtype = batch[0].dtype
        packed, cap = self._pack(op, batch, engine)
        warm_key = (op.name, dtype, engine, cap, self.num_shards)
        if self._shard_exec is not None:
            # shard-parallel packed launch: each shard is a dispatched
            # call over its tile-aligned slice; the batch is charged the
            # slowest shard
            return self._sharded_compute(op, tuple(packed), {}, engine,
                                         plan_key=(op.name, dtype, cap),
                                         warm_key=warm_key)
        tile = self._tile_override(op, engine, dtype)
        if tile is not None:
            warm_key = warm_key + (tuple(sorted(tile.items())),)
        launch_kw = {} if tile is None else {"tile_config": dict(tile)}
        return self._timed(warm_key, lambda: op(
            *packed, engine=engine, backend=self.backend, **launch_kw))

    def _run_sequential(self, op, batch: Sequence[Request],
                        engine: str) -> float:
        """Per-request fallback for families whose inputs don't pack."""
        total = 0.0
        for r in batch:
            args, kwargs = self._canonical(op.name, r.size, r.dtype)
            warm_key = (op.name, r.dtype, engine, r.size, self.num_shards)
            if self._shard_exec is not None:
                # each request splits across the mesh; requests within the
                # batch still run back to back, so their times add
                total += self._sharded_compute(
                    op, args, kwargs, engine,
                    plan_key=(op.name, r.dtype, r.size), warm_key=warm_key)
                continue
            total += self._timed(warm_key, lambda: op(
                *args, engine=engine, backend=self.backend, **kwargs))
        return total

    def execute(self, batch: List[Request]) -> BatchExecution:
        """Launch one formed batch; returns measured compute seconds."""
        kernel, dtype = batch[0].batch_key
        op = registry.get(kernel)
        args, kwargs = self._canonical(kernel, batch[0].size, dtype)
        engine, _ = self._resolve_engine(op, args, kwargs)
        if self._packable(args, kwargs, batch[0].size):
            compute_s = self._run_packed(op, batch, engine)
        else:
            compute_s = self._run_sequential(op, batch, engine)
        return BatchExecution(engine=engine, compute_s=compute_s,
                              shards=self.num_shards)
