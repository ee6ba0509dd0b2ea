"""Sharded execution of registry kernels via the dispatch layer.

The runtime half of :mod:`repro_torch.sharding.plan`: a
:class:`ShardedExecutor` takes an op + call arguments, plans the split
(:func:`~repro_torch.sharding.plan.plan_for`), and launches each shard
through ``repro_torch.core.dispatch.DEFAULT_DISPATCHER``, so every
per-shard launch gets the §6 engine decision and the per-(kernel, engine,
dtype, hw, shard shape) tuned tile config, exactly as an unsharded call
would.  Outputs are reassembled with
:func:`~repro_torch.sharding.plan.combine_outputs` and equal the unsharded
result bit for bit (halo rows carry the trapezoid dependency of Eq. 13;
data/head splits are independent; a head shard runs the unsharded call's
split-S schedule).

Timing model: the shards are launched one after another on the
executor's one device, each shard's time is the host wall time between
two synchronizations (``torch.cuda.synchronize`` on the card), and
:class:`ShardRun` reports both the serial sum and the ``parallel_s``
maximum: what an N-device mesh would charge the virtual serving clock
when the shards run side by side.  Per-shard *correctness* is real,
per-shard *time* is measured, and the N-way-parallel number is the
max-reduction the scheduler accounts, not a measured speedup.  A shard's
slice (and its copy, where the kernel needs one) is made before its
clock starts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Tuple

import torch

from ..core.dispatch import DEFAULT_DISPATCHER, Dispatcher
from ..obs.trace import TRACER
from .plan import (ShardPlan, combine_outputs, first_array, plan_for,
                   shard_call)

__all__ = ["ShardRun", "ShardedExecutor"]


def _sync(backend: str) -> None:
    if backend == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass(frozen=True)
class ShardRun:
    """One sharded execution: the combined output + per-shard times."""

    out: Any
    plan: ShardPlan
    shard_seconds: Tuple[float, ...]

    @property
    def parallel_s(self) -> float:
        """Wall time an N-way mesh is charged: the slowest shard."""
        return max(self.shard_seconds) if self.shard_seconds else 0.0

    @property
    def serial_s(self) -> float:
        """Total measured compute across shards (host wall time)."""
        return float(sum(self.shard_seconds))


class ShardedExecutor:
    """Run registry kernels shard by shard on one device.

    The execution engine behind ``repro_torch.bench kernels --mesh N`` and
    the serving batcher's shard-parallel packing: plans once per call
    shape, launches every shard through the dispatcher (memoized §6 Advice
    + tuned tiles per shard), and reassembles the exact unsharded result.
    ``engine`` follows the dispatch layer's conventions and ``backend``
    is the reference's ``interpret``: ``"cuda"`` launches the hand-written
    kernels, ``"plain"`` their plain versions on the CPU.
    ``num_shards=1`` degrades to one dispatched call wrapped in the same
    timing envelope.
    """

    def __init__(self, num_shards: int, *, engine: str = "auto",
                 backend: str = "cuda", dispatcher=None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.engine = engine
        self.backend = backend
        self.dispatcher = (dispatcher if dispatcher is not None
                           else DEFAULT_DISPATCHER)
        self._flat = None  # lazy mesh-1 view of self.dispatcher

    def _shard_dispatcher(self):
        """The dispatcher per-shard launches go through.

        A shard's launch is already the split: advising it under a
        mesh-configured dispatcher would plan a bogus sub-split onto its
        memoized Advice.  When the backing dispatcher has a mesh set,
        shards run through a flat (mesh-1) view sharing its advisor and
        tuning policy, so §6 routing and tuned tiles are identical and
        only the shard-spec planning is skipped.
        """
        if self.dispatcher.mesh_shards == 1:
            return self.dispatcher
        if self._flat is None:
            self._flat = Dispatcher(advisor=self.dispatcher.advisor,
                                    tuning=self.dispatcher.tuning)
        return self._flat

    def plan(self, op, *args, **kwargs) -> ShardPlan:
        """The ShardPlan this executor would use for one call."""
        return plan_for(op, self.num_shards, *args, **kwargs)

    def run(self, op, *args, engine: Optional[str] = None,
            plan: Optional[ShardPlan] = None, **kwargs) -> ShardRun:
        """Plan, launch every shard via dispatch, and reassemble.

        Each shard's launch is a normal ``Dispatcher.run`` (§6 engine
        routing and tuned tile lookup included), timed on its own so
        callers can account the shard-parallel (max) or serial (sum)
        cost.  Pass *plan* to reuse a prior plan across calls of the same
        shape (the serving batcher's steady-state path).
        """
        eng = self.engine if engine is None else engine
        if plan is None:
            plan = self.plan(op, *args, **kwargs)
        dispatcher = self._shard_dispatcher()
        outputs, times = [], []
        with TRACER.span("shard_run", layer="mesh", kernel=op.name,
                         kind=plan.spec.kind, shards=len(plan.shards)):
            for i, shard in enumerate(plan.shards):
                sargs, skw = shard_call(plan, shard, args, kwargs)
                _sync(self.backend)
                t0 = time.perf_counter()
                out = dispatcher.run(op, *sargs, engine=eng,
                                     backend=self.backend, **skw)
                _sync(self.backend)
                dt = time.perf_counter() - t0
                del sargs, skw
                # emitted with the measured times: span == sample
                TRACER.emit("shard", layer="mesh", start_s=t0, dur_s=dt,
                            kernel=op.name, shard=i)
                times.append(dt)
                outputs.append(out)
            template = first_array(args) if plan.spec.kind == "data" \
                else None
            with TRACER.span("reassembly", layer="mesh", kernel=op.name):
                combined = combine_outputs(plan, outputs,
                                           template=template)
        return ShardRun(out=combined, plan=plan,
                        shard_seconds=tuple(times))
