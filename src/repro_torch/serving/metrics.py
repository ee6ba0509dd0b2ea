"""Per-request latency capture → percentiles → schema-4 serving records.

Closes the measurement loop for the serving subsystem the same way
``repro_torch.bench.common`` does for kernel sweeps: a finished session's
:class:`~repro_torch.serving.scheduler.ServingLog` is reduced to a
:class:`ServingSummary` (p50/p95/p99 end-to-end latency with its
queue/compute split, throughput, goodput, and SLO attainment per
``repro_torch.serving.slo``), and :func:`serving_record` shapes one
summary into the schema-4 record dict that ``repro_torch.report.records``
ingests, ``repro_torch.report.claims`` verifies (§6 routing under load,
Eq. 4 boundedness, percentile/goodput consistency), and
``repro_torch.bench.compare`` gates across commits.

:func:`percentile` uses the same linear interpolation as
``numpy.percentile``'s default so the published tail numbers are
reproducible with stock tooling.  Pure Python and numpy, copied from
the reference package: the record fields and their rounding are the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .requests import RequestResult
from .scheduler import ServingLog
from .slo import SLO, DEFAULT_SLO

__all__ = ["ServingSummary", "format_summary", "percentile",
           "serving_record", "summarize"]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100), ``numpy.percentile`` semantics.

    Delegates to numpy so 'reproducible with stock tooling' holds by
    construction; returns 0.0 for an empty sample (an idle session has
    no tail).
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    if len(values) == 0:
        return 0.0
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


@dataclasses.dataclass(frozen=True)
class ServingSummary:
    """One serving session reduced to its publishable numbers.

    All latencies are milliseconds.  ``p*_ms`` are end-to-end
    (arrival → completion); the ``queue_*``/``compute_*`` companions
    split the same distribution at the batch-launch boundary.
    """

    offered: int
    completed: int
    batches: int
    mean_batch: float
    duration_s: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    queue_p50_ms: float
    queue_p99_ms: float
    compute_p50_ms: float
    compute_p99_ms: float
    throughput_rps: float
    goodput_rps: float
    slo_ms: float
    slo_attainment: float


def summarize(log: ServingLog, slo: SLO = DEFAULT_SLO) -> ServingSummary:
    """Reduce one session log to its latency/goodput summary."""
    done = [r for r in log.results if r.ok]
    lat = [r.latency_s * 1e3 for r in done]
    queue = [r.queue_s * 1e3 for r in done]
    compute = [r.compute_s * 1e3 for r in done]
    duration = log.duration_s
    return ServingSummary(
        offered=log.offered,
        completed=len(done),
        batches=len(log.batches),
        mean_batch=log.mean_batch,
        duration_s=duration,
        p50_ms=percentile(lat, 50.0),
        p95_ms=percentile(lat, 95.0),
        p99_ms=percentile(lat, 99.0),
        queue_p50_ms=percentile(queue, 50.0),
        queue_p99_ms=percentile(queue, 99.0),
        compute_p50_ms=percentile(compute, 50.0),
        compute_p99_ms=percentile(compute, 99.0),
        throughput_rps=(len(done) / duration if duration > 0 else 0.0),
        goodput_rps=slo.goodput_rps(done, duration),
        slo_ms=slo.latency_ms,
        slo_attainment=slo.attainment(done),
    )


def format_summary(summary: ServingSummary) -> list:
    """The human-facing session table, shared by every serving CLI.

    One source for the printed format so the launcher and the examples
    can never drift apart: batch accounting, the p50/p95/p99 rows with
    their queue/compute split, and the throughput/goodput/SLO line.
    """
    return [
        f"served {summary.completed}/{summary.offered} requests in "
        f"{summary.batches} batches (mean batch {summary.mean_batch:.2f})"
        f" over {summary.duration_s:.2f}s",
        "percentile   end-to-end      queue    compute",
        f"       p50 {summary.p50_ms:9.1f} ms {summary.queue_p50_ms:6.1f}"
        f" ms {summary.compute_p50_ms:6.1f} ms",
        f"       p95 {summary.p95_ms:9.1f} ms",
        f"       p99 {summary.p99_ms:9.1f} ms {summary.queue_p99_ms:6.1f}"
        f" ms {summary.compute_p99_ms:6.1f} ms",
        f"throughput {summary.throughput_rps:.1f} req/s; goodput "
        f"{summary.goodput_rps:.1f} req/s at SLO {summary.slo_ms:.0f} ms "
        f"(attainment {summary.slo_attainment:.1%})",
    ]


def serving_record(summary: ServingSummary, *, kernel: str, engine: str,
                   engine_auto: str, workload: str, rate_rps: float,
                   size: int, dtype: str, seed: int, intensity: float,
                   memory_bound: bool, mxu_ceiling: float,
                   max_batch: Optional[int] = None,
                   max_wait_ms: Optional[float] = None,
                   num_shards: int = 1,
                   mesh_exec_mode: Optional[str] = None,
                   model: Optional[str] = None,
                   phases: Optional[Dict] = None,
                   verdict: Optional[Dict] = None,
                   events: Optional[Dict] = None,
                   tuning: Optional[Dict] = None,
                   trace: Optional[Dict] = None,
                   results: Optional[Sequence[RequestResult]] = None,
                   ) -> Dict:
    """One schema-4 serving record: summary + analytic join fields.

    The analytic fields (``intensity`` per Eq. 2, ``memory_bound`` per
    Eq. 4, the Eq. 17/23/24 ``mxu_ceiling``, and what ``engine='auto'``
    resolved to) come from the executor's memoized Advice, so the
    claims layer can re-derive §6 routing for the record exactly as it
    does for kernel sweeps.  The batching-policy knobs (``max_batch``,
    ``max_wait_ms``) and the mesh width (``num_shards`` — batches were
    charged shard-parallel compute) ride along so the compare gate can
    refuse to join sessions formed under different policies.
    ``mesh_exec_mode`` says how sharded batches were charged:
    ``"virtual"`` = modeled max-over-shards clock, ``"mesh"`` =
    measured shard_map wall time on real devices — also part of the
    comparability contract (a measured p99 must not gate against a
    modeled one).

    Model-backed sessions (``workload='lm'``) additionally carry
    ``model`` (the full-size architecture name), ``phases`` (the
    measured prefill/decode wall split), and ``verdict`` (the per-op
    model-scale classification the ``model_verdict`` claim checks);
    all three are None for kernel sessions.

    Chaos sessions (:class:`~repro_torch.serving.elastic.ElasticSession`)
    carry ``events``: the failure/resize log, availability,
    recovery-latency totals, and the chaos-vs-fault-free checksums the
    ``elastic_integrity`` claim re-verifies.  None for ordinary
    sessions, and then absent from the record (event-less records keep
    the pre-elastic claim set).

    Online-tuned sessions (the online executor, ROADMAP Queue 1 item
    12) carry ``tuning``: the bandit's per-key arms and event log
    (``tuning_events``) plus the router's decision history, which the
    ``online_ceiling`` claim replays decision-by-decision.  None for
    statically-tuned sessions, and then absent from the record.

    ``trace`` is the observability reconciliation block (see
    :func:`repro_torch.serving.scheduler.trace_payload`): the tracer's
    independent account of the virtual timeline, checked against this
    record by the ``trace_reconciliation`` claim.
    """
    del results  # per-request samples stay in-process; records are sums
    return {
        **({"model": str(model)} if model is not None else {}),
        **({"phases": dict(phases)} if phases is not None else {}),
        **({"verdict": dict(verdict)} if verdict is not None else {}),
        **({"events": dict(events)} if events is not None else {}),
        **({"tuning": dict(tuning)} if tuning is not None else {}),
        **({"trace": dict(trace)} if trace is not None else {}),
        "num_shards": int(num_shards),
        "mesh_exec_mode": (str(mesh_exec_mode)
                           if mesh_exec_mode is not None else None),
        "max_batch": (int(max_batch) if max_batch is not None else None),
        "max_wait_ms": (round(float(max_wait_ms), 3)
                        if max_wait_ms is not None else None),
        "kernel": kernel,
        "engine": engine,
        "engine_auto": engine_auto,
        "workload": workload,
        "rate_rps": round(float(rate_rps), 3),
        "duration_s": round(float(summary.duration_s), 3),
        "size": int(size),
        "dtype": dtype,
        "seed": int(seed),
        "offered": int(summary.offered),
        "completed": int(summary.completed),
        "batches": int(summary.batches),
        "mean_batch": round(summary.mean_batch, 2),
        "p50_ms": round(summary.p50_ms, 3),
        "p95_ms": round(summary.p95_ms, 3),
        "p99_ms": round(summary.p99_ms, 3),
        "queue_p50_ms": round(summary.queue_p50_ms, 3),
        "queue_p99_ms": round(summary.queue_p99_ms, 3),
        "compute_p50_ms": round(summary.compute_p50_ms, 3),
        "compute_p99_ms": round(summary.compute_p99_ms, 3),
        "throughput_rps": round(summary.throughput_rps, 3),
        "goodput_rps": round(summary.goodput_rps, 3),
        "slo_ms": round(summary.slo_ms, 3),
        "slo_attainment": round(summary.slo_attainment, 4),
        "intensity": intensity,
        "memory_bound": bool(memory_bound),
        "mxu_ceiling": mxu_ceiling,
    }
