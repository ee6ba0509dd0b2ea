"""Admission queue + continuous batching over the engine dispatcher.

The serving control loop (paper §6 *in steady state*): requests arrive
on a virtual clock, wait in per-``batch_key`` FIFO queues, and are
formed into batches **continuously** — a batch launches as soon as its
queue reaches ``max_batch`` requests *or* its oldest request has waited
``max_wait_s`` (the size/age trigger), never on fixed synchronization
barriers.  Batch execution is delegated to an executor (the
padding-aware kernel packer in ``repro_torch.serving.batcher`` or the LM
decode executor in ``repro_torch.serving.lm``); the measured compute
time (on the card: the launch's completed time, synchronized at both
ends) is folded back into the virtual clock so queueing delay compounds
under load exactly as it would on a real serving node.

Fairness: the scheduler always serves the queue whose *head* has waited
longest, and each queue is FIFO — with bounded batch compute times this
gives a hard no-starvation guarantee (every admitted request launches
within ``max_wait_s`` plus the residual of the batch in flight, once
its queue's turn comes in oldest-first order).

The admission (``_admit``) and batch-forming (``_ready_key``) policy
methods are deliberately free of loop state, so the elastic session
(:mod:`repro_torch.serving.elastic`) reuses them headlessly.  Pure Python,
as in the reference package; the virtual ``batch`` / ``queue`` spans
and the ``admit`` instants go through :data:`repro_torch.obs.trace.TRACER`.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..obs.trace import TRACER
from .loadgen import LoadGen
from .requests import Request, RequestResult

__all__ = ["BatchExecution", "BatchPolicy", "ContinuousBatchingScheduler",
           "ServingLog", "trace_payload"]


def trace_payload(events, log: "ServingLog") -> Dict:
    """The record's ``trace`` reconciliation block for one session.

    Two independently-kept accounts of the same virtual timeline: the
    tracer's batch spans (emitted inside the serving loop) and the
    :class:`ServingLog`'s batch tuples.  The ``trace_reconciliation``
    claim proves they agree — span count == logged launches, summed
    span compute == summed logged compute (within float-rounding
    tolerance) — so a trace that drifts from the evidence it narrates
    turns the report red.
    """
    batch_spans = [e for e in events
                   if e.clock == "virtual" and e.name == "batch"]
    queue_spans = [e for e in events
                   if e.clock == "virtual" and e.name == "queue"]
    span_compute_ms = sum(e.dur_us for e in batch_spans) / 1e3
    log_compute_ms = sum(b[4] for b in log.batches) * 1e3
    return {
        "clock": "virtual",
        "batch_spans": len(batch_spans),
        "queue_spans": len(queue_spans),
        "span_compute_ms": round(span_compute_ms, 3),
        "log_compute_ms": round(log_compute_ms, 3),
    }


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """The two continuous-batching triggers: size and age.

    ``max_batch`` caps how many requests share one launch (the packer
    pads to this capacity so launch shapes stay stable); a queue
    whose head is older than ``max_wait_s`` launches immediately even
    if underfull, bounding the queueing tail at low offered load.
    """

    max_batch: int = 8
    max_wait_s: float = 0.02

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_s < 0:
            raise ValueError(
                f"max_wait_s must be >= 0, got {self.max_wait_s}")


@dataclasses.dataclass(frozen=True)
class BatchExecution:
    """What an executor reports back for one launched batch.

    ``compute_s`` is what the scheduler folds back into the virtual
    clock.  ``shards`` records how many ways the batch was split
    (1 = unsharded).
    """

    engine: str        # 'vector' | 'matrix' — what actually ran
    compute_s: float   # measured (or simulated) batch compute seconds
    shards: int = 1    # mesh shards the batch was split across


@dataclasses.dataclass(frozen=True)
class ServingLog:
    """Everything one serving session produced.

    ``results`` is per-request (arrival → batch → completion);
    ``batches`` is per-launch (key, size, start, compute, engine) for
    batch-formation diagnostics; ``offered`` counts every arrival the
    source emitted inside the horizon, completed or not.
    """

    results: Tuple[RequestResult, ...]
    batches: Tuple[Tuple[int, Tuple[str, str], int, float, float, str], ...]
    offered: int
    duration_s: float

    @property
    def completed(self) -> int:
        """Requests that made it through a batch launch."""
        return sum(1 for r in self.results if r.ok)

    @property
    def mean_batch(self) -> float:
        """Mean formed-batch size (launch efficiency under this load)."""
        if not self.batches:
            return 0.0
        return sum(b[2] for b in self.batches) / len(self.batches)


class ContinuousBatchingScheduler:
    """Event-driven serving loop: admit → form batches → execute.

    One instance runs one session: ``run(source, duration_s)`` drains
    the generator's arrivals through the size/age batching policy and
    returns the :class:`ServingLog`.  The executor owns engine
    selection (the paper's §6 decision, via the dispatcher's memoized
    Advice — routing cost off the hot path) and padding-aware packing;
    the scheduler owns *when* and *with whom* a request launches.
    An executor may define ``on_dequeue(batch, clock_s=, queue_depth=)``
    to observe each formed batch before its launch.
    """

    def __init__(self, executor, policy: Optional[BatchPolicy] = None):
        self.executor = executor
        self.policy = policy if policy is not None else BatchPolicy()

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _push(pending: List, req: Request) -> None:
        heapq.heappush(pending, (req.arrival_s, req.rid, req))

    def _admit(self, pending: List, queues: Dict, clock: float) -> None:
        """Move every arrival with ``arrival_s <= clock`` into its queue."""
        while pending and pending[0][0] <= clock:
            _, _, req = heapq.heappop(pending)
            queues.setdefault(req.batch_key, deque()).append(req)
            TRACER.instant("admit", layer="serving", at_s=req.arrival_s,
                           rid=req.rid, key=list(req.batch_key))

    def _ready_key(self, queues: Dict, clock: float, draining: bool):
        """The oldest-head queue that a trigger has fired for, if any."""
        best = None
        for key, q in queues.items():
            if not q:
                continue
            head = q[0]
            # the deadline is written exactly as the advance step
            # computes it (arrival + wait), so a clock parked *on* a
            # deadline always fires the trigger -- mixing this with the
            # algebraically equal `clock - arrival >= wait` can disagree
            # in floating point and stall the loop
            triggered = (len(q) >= self.policy.max_batch
                         or clock >= head.arrival_s + self.policy.max_wait_s
                         or draining)
            # ties on arrival_s break by rid (arrival order): two heads
            # admitted at the same virtual timestamp must dequeue in
            # the order they arrived, not dict-insertion order
            if triggered and (best is None
                              or (head.arrival_s, head.rid)
                              < (queues[best][0].arrival_s,
                                 queues[best][0].rid)):
                best = key
        return best

    # -- the session loop --------------------------------------------------

    def run(self, source: LoadGen, duration_s: float) -> ServingLog:
        """Serve *source*'s traffic for ``duration_s`` virtual seconds.

        Arrivals beyond the horizon are never admitted; arrivals inside
        it are always served (the tail drains after the horizon, so
        late-arriving requests still get latency samples instead of
        silently vanishing).
        """
        pending: List = []
        for req in source.initial(duration_s):
            self._push(pending, req)
        offered = len(pending)
        queues: Dict[Tuple[str, str], Deque[Request]] = {}
        results: List[RequestResult] = []
        batches: List[Tuple[int, Tuple[str, str], int, float, float, str]] = []
        clock, batch_id = 0.0, 0

        while pending or any(queues.values()):
            self._admit(pending, queues, clock)
            draining = not pending  # nothing else will arrive: flush
            key = self._ready_key(queues, clock, draining)
            if key is None:
                # no trigger fired: advance to the next event (an
                # arrival, or the oldest head's age deadline)
                nxt = pending[0][0] if pending else float("inf")
                for q in queues.values():
                    if q:
                        nxt = min(nxt, q[0].arrival_s
                                  + self.policy.max_wait_s)
                clock = max(clock, nxt)
                continue
            q = queues[key]
            batch = [q.popleft()
                     for _ in range(min(self.policy.max_batch, len(q)))]
            # executors that adapt to load (the SLO router / online
            # tuner) observe the dequeue signals here, before the
            # launch; plain executors simply lack the hook
            notify = getattr(self.executor, "on_dequeue", None)
            if notify is not None:
                depth = len(batch) + sum(len(qq)
                                         for qq in queues.values())
                notify(batch, clock_s=clock, queue_depth=depth)
            execution = self.executor.execute(batch)
            start, finish = clock, clock + execution.compute_s
            batches.append((batch_id, key, len(batch), start,
                            execution.compute_s, execution.engine))
            # the virtual-clock timeline: one batch span per launch,
            # one queue span per member (arrival -> launch wait)
            TRACER.virtual("batch", layer="serving", start_s=start,
                           dur_s=execution.compute_s, batch_id=batch_id,
                           key=list(key), n=len(batch),
                           engine=execution.engine,
                           shards=execution.shards)
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
                follow_up = source.on_complete(result, duration_s)
                if follow_up is not None:
                    self._push(pending, follow_up)
                    offered += 1
            batch_id += 1
            clock = finish
        results.sort(key=lambda r: (r.request.arrival_s, r.request.rid))
        return ServingLog(results=tuple(results), batches=tuple(batches),
                          offered=offered, duration_s=duration_s)
