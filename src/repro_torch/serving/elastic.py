"""Elastic, fault-tolerant serving: resize, re-dispatch, checkpoint.

The runtime layer (``repro_torch.runtime.checkpoint``,
``repro_torch.runtime.elastic``) wired into the serving stack so a session
survives the two things production meshes actually do -- change width and
lose shards -- without giving up one bit of the paper's verdict.  The
shards run one after another on one device (the
:class:`~repro_torch.sharding.ShardedExecutor`'s virtual clock), so the
whole module runs on one card, or on the CPU with the plain versions.
Three integration points:

* **Resize under load** -- :class:`ElasticSession` grows its shard width
  on queue-depth pressure and shrinks it when the queue drains, through
  ``Dispatcher.set_mesh`` (so the memoized §6 Advice re-plans its
  ShardSpecs) with each transition described by
  :func:`repro_torch.runtime.elastic.mesh_transition_plan`.  Eq. 2
  intensity is invariant under the data split, so the engine decision --
  and the Eq. 23/24 ceiling -- is identical at every width; the resize
  event records ``reshard_exact``, the bit-equality of the re-sharded
  execution against the pre-resize fingerprints, as evidence.
* **Shard failure mid-batch** -- a :class:`ChaosInjector` ``fail`` event
  kills one shard of the next launched batch.  The
  :class:`~repro_torch.sharding.plan.ShardPlan` already names the dead
  shard's ranges, so :func:`redispatch_failed_shard` re-runs exactly that
  slice through a flat dispatcher and the recovery is **bit-exact** (the
  event records the equality).  The recovery wall time is charged to the
  batch on the virtual clock -- failures cost latency, never answers.
* **Checkpoint/restore** -- :func:`checkpoint_session` snapshots the
  scheduler cursor (clock, batch id, completed request ids), the engine
  cache (the canonical per-class inputs), the per-request fingerprints,
  and the tuner state through
  :class:`repro_torch.runtime.checkpoint.AsyncCheckpointer`;
  :meth:`ElasticSession.restore` resumes the session from disk and serves
  only the not-yet-completed arrivals, landing on the same final checksum
  as an uninterrupted run.

**The integrity contract.**  Batch composition depends on measured wall
times folded into the virtual clock, so a chaos run and a fault-free run
form *different* batches -- raw outputs are not comparable.  What is
comparable: every request of a class (kernel, size, dtype) is served from
the same canonical seeded inputs, so one sharded execution per class
yields a **fingerprint** (the float64 sum of ``|output|``, taken on the
host with numpy as the reference takes it; bit-stable because split
execution reassembles the unsharded result bit for bit at any width), and
the session **checksum** is ``math.fsum`` of the completed requests'
fingerprints in request-id order.  The ``elastic_integrity`` claim
requires the chaos checksum to equal the fault-free one exactly --
failures and resizes may move latency, never results.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dispatch import DEFAULT_DISPATCHER, Dispatcher, normalize_engine
from ..kernels import registry
from ..obs.trace import TRACER
from ..obs.trace import capture as trace_capture
from ..runtime import checkpoint as ckpt
from ..runtime.elastic import mesh_transition_plan
from ..sharding import ShardedExecutor
from ..sharding.executor import _sync
from ..sharding.plan import ShardPlan, shard_call
from .batcher import KernelBatchExecutor
from .loadgen import make_loadgen
from .metrics import ServingSummary, serving_record, summarize
from .requests import RequestResult
from .scheduler import ContinuousBatchingScheduler, ServingLog, trace_payload
from .slo import availability

__all__ = ["AVAILABILITY_TARGET", "ChaosEvent", "ChaosInjector",
           "ElasticKernelExecutor", "ElasticSession", "P99_BOUND",
           "P99_SLACK_MS", "checkpoint_session", "redispatch_failed_shard"]

#: Default availability floor the ``elastic_integrity`` claim enforces:
#: completed/offered across the whole chaos session.  Injected failures
#: re-dispatch rather than drop, so a healthy elastic session serves every
#: admitted arrival and sits at 1.0.
AVAILABILITY_TARGET = 0.99

#: Default p99 degradation bound: the chaos p99 may be at most this
#: multiple of the fault-free p99 (plus ``P99_SLACK_MS``).
P99_BOUND = 10.0

#: Additive slack (ms) on the p99 bound, so near-idle sessions whose
#: fault-free p99 is sub-millisecond don't fail on measurement noise.
P99_SLACK_MS = 250.0


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled adversity on the virtual serving clock.

    ``kind='fail'`` kills shard ``shard`` of the next batch launched at or
    after ``at_s``; ``kind='resize'`` retargets the mesh width to
    ``width`` at ``at_s``.
    """

    kind: str           # 'fail' | 'resize'
    at_s: float         # virtual-clock firing time (seconds)
    shard: int = 0      # fail: which shard dies (clamped to the width)
    width: int = 0      # resize: target mesh width


def _parse_chaos_spec(spec: str) -> Tuple[ChaosEvent, ...]:
    """``"fail@T[:SHARD],resize@T:WIDTH,..."`` -> sorted ChaosEvents."""
    events: List[ChaosEvent] = []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        kind, sep, rest = token.partition("@")
        if not sep or kind not in ("fail", "resize"):
            raise ValueError(
                f"bad chaos token {token!r}: want fail@T[:SHARD] or "
                f"resize@T:WIDTH")
        at, _, val = rest.partition(":")
        at_s = float(at)
        if at_s < 0:
            raise ValueError(f"bad chaos token {token!r}: time must "
                             f"be >= 0")
        if kind == "fail":
            events.append(ChaosEvent("fail", at_s,
                                     shard=int(val) if val else 0))
        else:
            if not val:
                raise ValueError(f"bad chaos token {token!r}: resize "
                                 f"needs a target width")
            width = int(val)
            if width < 1:
                raise ValueError(f"bad chaos token {token!r}: width "
                                 f"must be >= 1")
            events.append(ChaosEvent("resize", at_s, width=width))
    return tuple(sorted(events, key=lambda e: (e.at_s, e.kind)))


class ChaosInjector:
    """The seeded fault/resize adversary an :class:`ElasticSession` rides.

    Built from a deterministic spec string (``"fail@0.6:1,resize@1.1:4"``)
    so the same chaos replays exactly across runs and machines -- the
    compare gate refuses to join serving records whose specs differ.
    :meth:`seeded` derives a spec from an RNG seed; the derivation is pure
    (the reference's numpy draws), so the seed *is* the spec.
    """

    def __init__(self, spec: str):
        self.spec = spec
        self.events = _parse_chaos_spec(spec)

    @classmethod
    def seeded(cls, seed: int, duration_s: float, *,
               max_width: int = 4) -> "ChaosInjector":
        """A deterministic fail -> grow -> shrink spec drawn from *seed*.

        One shard failure in the first half of the horizon, a grow and a
        shrink in the second -- the minimal storyline that exercises
        every transition of the failure/resize state machine.
        """
        rng = np.random.default_rng(seed)
        t_fail = duration_s * (0.2 + 0.25 * float(rng.uniform()))
        t_up = duration_s * (0.5 + 0.15 * float(rng.uniform()))
        t_dn = duration_s * (0.75 + 0.15 * float(rng.uniform()))
        shard = int(rng.integers(0, max(1, max_width)))
        wide = int(rng.integers(2, max(3, max_width + 1)))
        return cls(f"fail@{t_fail:.3f}:{shard},"
                   f"resize@{t_up:.3f}:{wide},"
                   f"resize@{t_dn:.3f}:1")

    def __len__(self) -> int:
        """How many events this injector schedules."""
        return len(self.events)


def redispatch_failed_shard(op, plan: ShardPlan, failed_index: int,
                            args: tuple, kwargs: Optional[dict] = None, *,
                            engine: str = "auto", backend: str = "cuda",
                            dispatcher=None) -> Tuple[Any, float]:
    """Re-run one dead shard's planned ranges on surviving resources.

    The :class:`~repro_torch.sharding.plan.ShardPlan` already names
    exactly which slice of the call the dead shard owned, so recovery is
    one dispatched launch of ``shard_call(plan, shards[failed_index],
    ...)`` -- same §6 engine routing, same tuned tiles, same kernel (and,
    for a head shard, the same split-S schedule) as the original shard,
    hence bit-exact output.  Returns ``(output, recovery_seconds)``: the
    host wall time between two synchronizations, which the caller charges
    to the batch on the virtual clock.

    *dispatcher* defaults to a flat (mesh-1) view of the default
    dispatcher: the re-dispatched slice is already the split (as in
    ``ShardedExecutor._shard_dispatcher``).
    """
    kwargs = dict(kwargs or {})
    shard = plan.shards[failed_index]
    sargs, skw = shard_call(plan, shard, args, kwargs)
    disp = dispatcher if dispatcher is not None else DEFAULT_DISPATCHER
    if disp.mesh_shards > 1:
        disp = Dispatcher(advisor=disp.advisor, tuning=disp.tuning)
    _sync(backend)
    t0 = time.perf_counter()
    out = disp.run(op, *sargs, engine=engine, backend=backend, **skw)
    _sync(backend)
    return out, time.perf_counter() - t0


def _owned_slice(plan: ShardPlan, shard, combined: torch.Tensor
                 ) -> torch.Tensor:
    """The combined output's slice that *shard* owned."""
    kind = plan.spec.kind
    if kind == "data":
        return combined.reshape(-1)[shard.start:shard.stop]
    if kind == "rowblock":
        return combined[shard.start:shard.stop]
    return combined[:, shard.start:shard.stop]  # head: split axis 1


def _crop_recovered(plan: ShardPlan, shard, out: torch.Tensor
                    ) -> torch.Tensor:
    """A re-dispatched shard output cropped to its owned range."""
    if plan.spec.kind == "data":
        return out.reshape(-1)
    if plan.spec.kind == "rowblock" and (shard.lo or shard.hi):
        return out[shard.lo:shard.lo + shard.owned]
    return out


def _fingerprint(out: torch.Tensor) -> float:
    """float64 ``sum(|out|)`` on the host, by numpy as the reference sums."""
    host = out.detach().to("cpu").double().numpy()
    return float(np.abs(host).sum())


class ElasticKernelExecutor(KernelBatchExecutor):
    """A :class:`KernelBatchExecutor` that can lose shards and refit.

    Three deltas from the base executor: every launch flows through a
    :class:`~repro_torch.sharding.ShardedExecutor` even at width 1 (so a
    pending failure always has a ShardPlan to kill a shard of); an
    injected failure is applied to the next timed launch -- the dead
    shard's owned output slice is re-dispatched via
    :func:`redispatch_failed_shard`, checked bit-exact, and its recovery
    wall time added to the batch's charge; and each (kernel, size, dtype,
    engine) class exposes a :meth:`fingerprint` -- the float64 ``|output|``
    sum of one sharded execution of the class's canonical inputs, the unit
    the session checksum and the resize ``reshard_exact`` evidence are
    built from.

    *inputs* shares the canonical-input cache with a predecessor executor
    across a resize, so every width serves identical request payloads (the
    fingerprints would expose a drift).
    """

    def __init__(self, engine: str = "auto", *, max_batch: int = 8,
                 backend: str = "cuda", seed: int = 0,
                 num_shards: int = 1,
                 inputs: Optional[Dict] = None):
        super().__init__(engine, max_batch=max_batch, backend=backend,
                         seed=seed, num_shards=num_shards)
        if self._shard_exec is None:  # width 1: still plan + shard
            self._shard_exec = ShardedExecutor(1, backend=backend)
        if inputs is not None:
            self._inputs = inputs
        self._fingerprints: Dict[Tuple[str, int, str, str], float] = {}
        self._pending_failure: Optional[int] = None
        self._failure_reports: List[Dict[str, Any]] = []

    def inject_failure(self, shard: int) -> None:
        """Arm a one-shot shard failure for the next timed launch."""
        self._pending_failure = int(shard)

    @property
    def failure_armed(self) -> bool:
        """True while an injected failure awaits its launch."""
        return self._pending_failure is not None

    def take_failure_reports(self) -> List[Dict[str, Any]]:
        """Drain the applied-failure reports accumulated since last call."""
        reports, self._failure_reports = self._failure_reports, []
        return reports

    def _sharded_compute(self, op, args: tuple, kwargs: dict,
                         engine: str, plan_key: Tuple,
                         warm_key: Tuple) -> float:
        """The base shard launch, plus pending-failure application.

        Keeps the combined output of the timed run so an armed failure can
        compare the dead shard's lost slice against its re-dispatch -- the
        ``redispatch_exact`` bit the claims layer checks.
        """
        plan = self._plans.get(plan_key)
        if plan is None:
            plan = self._plans[plan_key] = \
                self._shard_exec.plan(op, *args, **kwargs)
        if warm_key not in self._warmed:
            self._shard_exec.run(op, *args, engine=engine, plan=plan,
                                 **kwargs)
            self._warmed.add(warm_key)
        run = self._shard_exec.run(op, *args, engine=engine, plan=plan,
                                   **kwargs)
        compute_s = run.parallel_s
        if self._pending_failure is not None:
            idx = min(self._pending_failure, len(plan.shards) - 1)
            self._pending_failure = None
            recovered, recovery_s = redispatch_failed_shard(
                op, plan, idx, args, kwargs, engine=engine,
                backend=self.backend)
            lost = _owned_slice(plan, plan.shards[idx], run.out)
            got = _crop_recovered(plan, plan.shards[idx], recovered)
            self._failure_reports.append({
                "shard": idx,
                "width": len(plan.shards),
                "recovery_s": recovery_s,
                "exact": bool(torch.equal(lost, got)),
            })
            compute_s += recovery_s
        return compute_s

    def fingerprint(self, kernel: str, size: int, dtype: str,
                    engine: str) -> float:
        """The class fingerprint: float64 ``sum(|out|)`` of one sharded
        execution of the canonical inputs at this executor's width.

        Bit-stable across widths because split execution reassembles the
        unsharded result bit for bit (the sum walks the same full-shape
        array in the same order), which is exactly what a resize's
        ``reshard_exact`` check verifies.
        """
        key = (kernel, size, dtype, engine)
        fp = self._fingerprints.get(key)
        if fp is None:
            op = registry.get(kernel)
            args, kwargs = self._canonical(kernel, size, dtype)
            plan_key = (op.name, dtype, size)
            plan = self._plans.get(plan_key)
            if plan is None:
                plan = self._plans[plan_key] = \
                    self._shard_exec.plan(op, *args, **kwargs)
            run = self._shard_exec.run(op, *args, engine=engine,
                                       plan=plan, **kwargs)
            fp = self._fingerprints[key] = _fingerprint(run.out)
        return fp


def _input_tree(args: tuple) -> Dict[str, torch.Tensor]:
    """``{"arg<i>": tensor}`` for the tensor arguments of one class."""
    arrs = [a for a in args if isinstance(a, torch.Tensor)]
    return {f"arg{i}": a for i, a in enumerate(arrs)}


class ElasticSession:
    """A serving session that resizes, survives failures, and resumes.

    Owns the same loadgen -> continuous-batching -> metrics pipeline as
    :func:`repro_torch.serving.session.run_session`, with three
    additions: width elasticity (grow one shard when the admitted queue
    depth reaches ``grow_depth``, shrink toward the configured width after
    ``idle_shrink_s`` of empty queues), an optional :class:`ChaosInjector`
    whose events fire on the virtual clock, and a checkpoint/restore path
    (:func:`checkpoint_session` / :meth:`restore`).  :meth:`run` serves
    the chaos session **and** a fault-free replay at the configured width,
    then publishes one schema-4 record whose ``events`` block carries the
    failure/resize log, availability, recovery latency, and both checksums
    -- the evidence the ``elastic_integrity`` claim re-checks.

    Open-loop workloads only (poisson/bursty/trace): a closed-loop
    generator's arrivals react to measured completion times, so its
    offered stream could never match between a chaos run and its
    fault-free replay.  Virtual clock only (``real_mesh`` is refused).
    """

    def __init__(self, cfg, *, injector: Optional[ChaosInjector] = None,
                 min_shards: int = 1, max_shards: int = 8,
                 grow_depth: Optional[int] = None,
                 idle_shrink_s: float = 0.1,
                 resize_cooldown_s: float = 0.1,
                 availability_target: float = AVAILABILITY_TARGET,
                 p99_bound: float = P99_BOUND,
                 dispatcher=None):
        if cfg.real_mesh:
            raise ValueError(
                "ElasticSession is virtual-mesh only: failure re-dispatch "
                "is checked bit-exact against the shards of the virtual "
                "clock")
        if cfg.workload == "closed":
            raise ValueError(
                "ElasticSession needs an open-loop workload "
                "(poisson/bursty/trace): closed-loop arrivals react to "
                "measured completions, so a fault-free replay would "
                "see different offered load")
        self.cfg = cfg
        self.injector = injector
        self.min_shards = max(1, int(min_shards))
        self.max_shards = max(self.min_shards, int(max_shards))
        self.grow_depth = (int(grow_depth) if grow_depth is not None
                           else 2 * cfg.policy.max_batch)
        self.idle_shrink_s = float(idle_shrink_s)
        self.resize_cooldown_s = float(resize_cooldown_s)
        self.availability_target = float(availability_target)
        self.p99_bound = float(p99_bound)
        self.dispatcher = (dispatcher if dispatcher is not None
                           else DEFAULT_DISPATCHER)
        self._resume: Optional[Dict[str, Any]] = None
        self._state: Optional[Dict[str, Any]] = None
        self._ckpt: Optional[ckpt.AsyncCheckpointer] = None

    # -- construction helpers ----------------------------------------------

    def _make_executor(self, width: int,
                       inputs: Optional[Dict] = None
                       ) -> ElasticKernelExecutor:
        """An executor at *width* sharing the canonical-input cache."""
        cfg = self.cfg
        return ElasticKernelExecutor(
            engine=cfg.engine, max_batch=cfg.policy.max_batch,
            backend=cfg.backend, seed=cfg.seed, num_shards=width,
            inputs=inputs)

    def _source(self):
        """The session's seeded open-loop traffic generator."""
        cfg = self.cfg
        return make_loadgen(cfg.workload, cfg.kernel,
                            rate_rps=cfg.rate_rps, size=cfg.size,
                            dtype=cfg.dtype, seed=cfg.seed,
                            trace_path=cfg.trace_path)

    def _resize(self, executor: ElasticKernelExecutor, old_w: int,
                new_w: int, reason: str, at_s: float,
                events: List[Dict]) -> Tuple[ElasticKernelExecutor, int]:
        """One width transition: rebuild, verify, re-mesh, record.

        The new executor shares the old one's canonical inputs, every
        already-served class is re-fingerprinted at the new width and
        compared bitwise (``reshard_exact``), the dispatcher's mesh is
        retargeted via ``set_mesh`` (dropping the memoized Advice so
        ShardSpecs re-plan), and the event entry carries
        :func:`mesh_transition_plan`'s description.
        """
        new_w = max(self.min_shards, min(int(new_w), self.max_shards))
        if new_w == old_w:
            return executor, old_w
        new_exec = self._make_executor(new_w, inputs=executor._inputs)
        reshard_exact = True
        for (kernel, size, dtype, engine), fp in sorted(
                executor._fingerprints.items()):
            if new_exec.fingerprint(kernel, size, dtype, engine) != fp:
                reshard_exact = False
        if executor.failure_armed:
            # an armed failure survives the resize: the shard dies on the
            # new mesh's next launch
            new_exec._pending_failure = executor._pending_failure
        self.dispatcher.set_mesh(new_w, mode="virtual")
        plan = mesh_transition_plan({"data": old_w}, {"data": new_w})
        events.append({
            "kind": "resize", "at_s": round(float(at_s), 6),
            "from": int(old_w), "to": int(new_w), "reason": reason,
            "dp_rescale": plan["dp_rescale"],
            "tp_change": plan["tp_change"],
            "reshard_exact": bool(reshard_exact),
        })
        TRACER.instant("resize", layer="elastic", at_s=round(float(at_s), 6),
                       src=int(old_w), dst=int(new_w), reason=reason,
                       reshard_exact=bool(reshard_exact))
        return new_exec, new_w

    # -- the elastic serving loop ------------------------------------------

    def serve(self, *, chaos: bool = True,
              stop_after_batches: Optional[int] = None) -> ServingLog:
        """Run (or resume) the elastic loop; the chaos leg of a session.

        ``chaos=False`` disables both the injector and the elasticity
        policy -- the fault-free replay leg :meth:`run` compares against.
        ``stop_after_batches`` halts after that many launches with the
        loop state captured for :func:`checkpoint_session` (the
        mid-flight restart drill).  Returns the
        :class:`~repro_torch.serving.scheduler.ServingLog`; the loop state
        -- events, fingerprints, checksum -- stays on the session.
        """
        cfg = self.cfg
        policy = cfg.policy
        sched = ContinuousBatchingScheduler(None, policy)
        source = self._source()
        duration = cfg.duration_s
        resume, self._resume = self._resume, None

        pending: List = []
        prior_completed = resume["completed"] if resume else set()
        for req in source.initial(duration):
            if req.rid in prior_completed:
                continue
            sched._push(pending, req)
        offered = len(pending) + len(prior_completed)
        queues: Dict[Tuple[str, str], Any] = {}
        results: List[RequestResult] = []
        batches: List[Tuple] = []
        clock = resume["clock"] if resume else 0.0
        batch_id = resume["batch_id"] if resume else 0
        base_width = max(self.min_shards,
                         min(cfg.num_shards, self.max_shards))
        width = resume["width"] if resume else base_width
        fingerprints: Dict[int, float] = (dict(resume["fingerprints"])
                                          if resume else {})
        events: List[Dict] = list(resume["events"]) if resume else []
        recovery_s = resume["recovery_s"] if resume else 0.0
        executor = self._make_executor(width)
        evq = list(self.injector.events) if (chaos and self.injector) \
            else []
        ei = 0
        launched = 0
        idle_since: Optional[float] = None
        last_resize = clock - self.resize_cooldown_s
        orig_mesh = (self.dispatcher.mesh_shards,
                     self.dispatcher.mesh_mode)

        try:
            while pending or any(queues.values()):
                while ei < len(evq) and evq[ei].at_s <= clock:
                    ev = evq[ei]
                    ei += 1
                    if ev.kind == "fail":
                        executor.inject_failure(ev.shard)
                        TRACER.instant("chaos_fail", layer="elastic",
                                       at_s=round(float(ev.at_s), 6),
                                       shard=int(ev.shard))
                    else:
                        executor, width = self._resize(
                            executor, width, ev.width, "injected",
                            clock, events)
                        last_resize = clock
                sched._admit(pending, queues, clock)
                draining = not pending
                depth = sum(len(q) for q in queues.values())
                if chaos and self.max_shards > self.min_shards:
                    if (depth >= self.grow_depth
                            and width < self.max_shards
                            and clock - last_resize
                            >= self.resize_cooldown_s):
                        executor, width = self._resize(
                            executor, width, width + 1,
                            "queue-pressure", clock, events)
                        last_resize = clock
                    elif depth == 0 and width > base_width and pending:
                        if idle_since is None:
                            idle_since = clock
                        elif clock - idle_since >= self.idle_shrink_s:
                            executor, width = self._resize(
                                executor, width, width - 1,
                                "idle-drain", clock, events)
                            last_resize = clock
                            idle_since = clock
                    if depth > 0:
                        idle_since = None
                key = sched._ready_key(queues, clock, draining)
                if key is None:
                    nxt = pending[0][0] if pending else float("inf")
                    for q in queues.values():
                        if q:
                            nxt = min(nxt, q[0].arrival_s
                                      + policy.max_wait_s)
                    if ei < len(evq):
                        nxt = min(nxt, evq[ei].at_s)
                    clock = max(clock, nxt)
                    continue
                q = queues[key]
                batch = [q.popleft()
                         for _ in range(min(policy.max_batch, len(q)))]
                execution = executor.execute(batch)
                compute_s = execution.compute_s
                start, finish = clock, clock + compute_s
                for rep in executor.take_failure_reports():
                    recovery_s += rep["recovery_s"]
                    events.append({
                        "kind": "fail", "at_s": round(start, 6),
                        "shard": rep["shard"], "width": rep["width"],
                        "batch_id": batch_id,
                        "recovery_ms": round(rep["recovery_s"] * 1e3, 3),
                        "redispatch_exact": rep["exact"],
                    })
                    TRACER.virtual(
                        "redispatch", layer="elastic", start_s=start,
                        dur_s=rep["recovery_s"], shard=rep["shard"],
                        batch_id=batch_id, exact=rep["exact"])
                    if width > self.min_shards:
                        # the dead shard leaves the mesh: drain to the
                        # surviving width until pressure regrows it
                        executor, width = self._resize(
                            executor, width, width - 1,
                            "shard-failure", finish, events)
                        last_resize = finish
                batches.append((batch_id, key, len(batch), start,
                                compute_s, execution.engine))
                TRACER.virtual("batch", layer="serving", start_s=start,
                               dur_s=compute_s, batch_id=batch_id,
                               key=list(key), n=len(batch),
                               engine=execution.engine, shards=width)
                for req in batch:
                    TRACER.virtual("queue", layer="serving",
                                   start_s=req.arrival_s,
                                   dur_s=start - req.arrival_s,
                                   rid=req.rid, batch_id=batch_id)
                    result = RequestResult(
                        request=req, start_s=start, finish_s=finish,
                        batch_id=batch_id, batch_size=len(batch),
                        engine=execution.engine)
                    results.append(result)
                    fingerprints[req.rid] = executor.fingerprint(
                        req.kernel, req.size, req.dtype,
                        execution.engine)
                    follow_up = source.on_complete(result, duration)
                    if follow_up is not None:
                        sched._push(pending, follow_up)
                        offered += 1
                batch_id += 1
                launched += 1
                clock = finish
                if stop_after_batches is not None \
                        and launched >= stop_after_batches:
                    break
            if executor.failure_armed:
                # armed but no batch ever launched to apply it to
                executor._pending_failure = None
                events.append({"kind": "fail", "at_s": round(clock, 6),
                               "skipped": True})
            for ev in evq[ei:]:
                events.append({"kind": ev.kind,
                               "at_s": round(float(ev.at_s), 6),
                               "skipped": True})
        finally:
            self.dispatcher.set_mesh(*orig_mesh)
        self._state = {
            "clock": clock, "batch_id": batch_id, "width": width,
            "offered": offered, "recovery_s": recovery_s,
            "fingerprints": dict(fingerprints),
            "events": list(events), "launched": launched,
        }
        results.sort(key=lambda r: (r.request.arrival_s, r.request.rid))
        return ServingLog(results=tuple(results), batches=tuple(batches),
                          offered=offered, duration_s=duration)

    # -- session state -----------------------------------------------------

    @property
    def events(self) -> List[Dict]:
        """The failure/resize event log of the last :meth:`serve`."""
        return list(self._state["events"]) if self._state else []

    def checksum(self) -> float:
        """``math.fsum`` of completed-request fingerprints in rid order.

        The bit-exactness invariant of the whole module: identical
        between a chaos run and its fault-free replay, identical between
        an interrupted+resumed session and a straight one.
        """
        if not self._state:
            return 0.0
        fps = self._state["fingerprints"]
        return math.fsum(fps[r] for r in sorted(fps))

    # -- the published session ---------------------------------------------

    def run(self) -> Tuple[ServingLog, ServingSummary, Dict]:
        """Chaos run + fault-free replay -> one schema-4 record.

        The fault-free leg replays the same seeded traffic at the
        configured width with no injector and no elasticity; its
        completion counts, p99, and checksum anchor the ``events`` block
        the ``elastic_integrity`` claim checks: availability >= target,
        chaos checksum == fault-free checksum (bit-exact), chaos p99 <=
        bound x fault-free p99 + slack.
        """
        cfg = self.cfg
        base_log = self.serve(chaos=False)
        base_summary = summarize(base_log, cfg.slo)
        base_checksum = self.checksum()
        with trace_capture() as view:
            log = self.serve(chaos=True)
        trace = trace_payload(view.events, log)
        # the chaos leg's extra timeline marks, reconciled against the
        # events block: every recorded failure/resize has its instant on
        # the virtual clock
        trace["chaos_instants"] = sum(
            1 for e in view.events
            if e.kind == "instant" and e.layer == "elastic")
        trace["redispatch_spans"] = sum(
            1 for e in view.events if e.name == "redispatch")
        summary = summarize(log, cfg.slo)
        fail_events = [e for e in self.events if e["kind"] == "fail"
                       and not e.get("skipped")]
        resize_events = [e for e in self.events if e["kind"] == "resize"]
        events_block = {
            "spec": self.injector.spec if self.injector else "",
            "availability": round(
                availability(log.completed, log.offered), 6),
            "availability_target": self.availability_target,
            "p99_bound": self.p99_bound,
            "p99_slack_ms": P99_SLACK_MS,
            "checksum": self.checksum(),
            "failures": len(fail_events),
            "resizes": len(resize_events),
            "recovery_ms_total": round(
                self._state["recovery_s"] * 1e3, 3),
            "fault_free": {
                "completed": int(base_summary.completed),
                "offered": int(base_summary.offered),
                "p99_ms": round(base_summary.p99_ms, 3),
                "checksum": base_checksum,
            },
            "log": list(self.events),
        }
        advice = self._make_executor(1).advice_for(
            cfg.kernel, cfg.size, cfg.dtype)
        forced = normalize_engine(cfg.engine)
        engines = {r.engine for r in log.results} or \
            {forced if forced is not None else advice.engine}
        engine = engines.pop() if len(engines) == 1 else "mixed"
        record = serving_record(
            summary, kernel=cfg.kernel, engine=engine,
            engine_auto=advice.engine, workload=cfg.workload,
            rate_rps=cfg.rate_rps, size=cfg.size, dtype=cfg.dtype,
            seed=cfg.seed, intensity=advice.intensity,
            memory_bound=advice.memory_bound,
            mxu_ceiling=advice.max_speedup_matrix,
            max_batch=cfg.policy.max_batch,
            max_wait_ms=cfg.policy.max_wait_s * 1e3,
            num_shards=cfg.num_shards,
            mesh_exec_mode=("virtual" if cfg.num_shards > 1 else None),
            events=events_block, trace=trace)
        return log, summary, record

    # -- checkpoint / restore ----------------------------------------------

    def _checkpointer(self, ckpt_dir) -> ckpt.AsyncCheckpointer:
        """The session's lazily-built async checkpoint writer."""
        if self._ckpt is None or \
                str(self._ckpt.ckpt_dir) != str(ckpt_dir):
            self._ckpt = ckpt.AsyncCheckpointer(ckpt_dir)
        return self._ckpt

    @classmethod
    def restore(cls, cfg, ckpt_dir, *, step: Optional[int] = None,
                **kwargs) -> "ElasticSession":
        """Rebuild a session from a :func:`checkpoint_session` snapshot.

        Loads the scheduler cursor, completed-request fingerprints, and
        engine-cache tensors through ``runtime/checkpoint.restore``,
        verifies the checkpointed canonical inputs against the
        seed-regenerated ones leaf by leaf (a checkpoint from a different
        seed or kernel must be refused, not silently adopted), and arms
        the next :meth:`serve` to skip the already-completed arrivals --
        the resumed run lands on the same final checksum as an
        uninterrupted one.
        """
        step = step if step is not None else ckpt.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        meta = ckpt.checkpoint_meta(ckpt_dir, step)
        extra = meta.get("extra", {})
        n = int(extra["n_completed"])
        session = cls(cfg, **kwargs)
        probe = session._make_executor(1)
        inputs_tpl: Dict[str, Dict[str, torch.Tensor]] = {}
        for ckey in extra.get("classes", []):
            kernel, size, dtype = ckey.split("|")
            args, _ = probe._canonical(kernel, int(size), dtype)
            inputs_tpl[ckey] = _input_tree(args)
        template = {
            "completed_rids": np.zeros(n, np.int64),
            "request_fps": np.zeros(n, np.float64),
            "checksum": np.float64(0.0),
            "inputs": inputs_tpl,
        }
        state = ckpt.restore(ckpt_dir, template, step=step)
        for ckey, want in inputs_tpl.items():
            got = state["inputs"][ckey]
            for name in sorted(want, key=lambda k: int(k[3:])):
                if not torch.equal(got[name], want[name]):
                    raise ValueError(
                        f"engine cache leaf mismatch for {ckey}/{name}:"
                        f" the checkpointed canonical inputs do not "
                        f"match this session's seed")
        rids = [int(r) for r in np.asarray(state["completed_rids"])]
        fps = [float(f) for f in np.asarray(state["request_fps"])]
        session._resume = {
            "clock": float(extra["clock"]),
            "batch_id": int(extra["batch_id"]),
            "width": int(extra["width"]),
            "completed": set(rids),
            "fingerprints": dict(zip(rids, fps)),
            "events": list(extra.get("events", [])),
            "recovery_s": float(extra.get("recovery_s", 0.0)),
        }
        return session


def checkpoint_session(session: ElasticSession, ckpt_dir, *,
                       step: Optional[int] = None,
                       keep: Optional[int] = None) -> int:
    """Snapshot a served/paused session through ``AsyncCheckpointer``.

    Saves, atomically and on the writer thread: the completed request ids
    and their fingerprints (scheduler state -- what must not be served
    twice), the session checksum, the canonical per-class input tensors
    (engine-cache state -- verified bit-exact on restore; a bfloat16
    class is stored as the reference stores bfloat16), and in the
    manifest's ``extra`` the virtual-clock cursor, mesh width, event log,
    and the dispatcher's tuner entries.  Waits for the write so a crash
    immediately after this call still finds a complete checkpoint;
    ``keep`` prunes older steps (:func:`repro_torch.runtime.checkpoint.
    prune_old`).  Returns the step number (defaults to the batch counter).
    """
    state = session._state
    if state is None:
        raise RuntimeError(
            "nothing to checkpoint: serve() has not run on this session")
    rids = sorted(state["fingerprints"])
    inputs_tree: Dict[str, Dict[str, torch.Tensor]] = {}
    classes = []
    executor = session._make_executor(1)
    cfg = session.cfg
    for kernel, size, dtype in sorted({(cfg.kernel, cfg.size, cfg.dtype)}):
        args, _ = executor._canonical(kernel, size, dtype)
        ckey = f"{kernel}|{size}|{dtype}"
        classes.append(ckey)
        inputs_tree[ckey] = _input_tree(args)
    tree = {
        "completed_rids": np.asarray(rids, np.int64),
        "request_fps": np.asarray(
            [state["fingerprints"][r] for r in rids], np.float64),
        "checksum": np.float64(session.checksum()),
        "inputs": inputs_tree,
    }
    cache = session.dispatcher.tuning.cache
    tuning_state = []
    if cache is not None:
        for entry in cache:
            to_json = getattr(entry, "to_json", None)
            tuning_state.append(to_json() if to_json else repr(entry))
    extra = {
        "n_completed": len(rids),
        "clock": state["clock"],
        "batch_id": state["batch_id"],
        "width": state["width"],
        "offered": state["offered"],
        "recovery_s": state["recovery_s"],
        "events": state["events"],
        "classes": classes,
        "kernel": cfg.kernel,
        "seed": cfg.seed,
        "tuning": tuning_state,
    }
    step = int(state["batch_id"]) if step is None else int(step)
    writer = session._checkpointer(ckpt_dir)
    writer.save(step, tree, extra=extra)
    writer.wait()
    if keep is not None:
        ckpt.prune_old(ckpt_dir, keep=keep)
    return step
