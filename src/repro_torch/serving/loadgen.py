"""Seeded, replayable traffic generators for the serving subsystem.

Four workload models, all emitting :class:`~repro_torch.serving.requests.Request`
streams against any registered kernel family or the LM decode path:

* :class:`PoissonLoadGen` — open-loop Poisson arrivals (exponential
  inter-arrival times at ``rate_rps``), the steady-state traffic model
  the paper's engine question matters under.
* :class:`BurstyLoadGen` — on/off modulated Poisson (duty-cycled
  between a high and a low rate), the tail-latency stressor.
* :class:`ClosedLoopLoadGen` — ``clients`` concurrent clients, each
  issuing its next request ``think_s`` after the previous completes;
  offered load adapts to service capacity instead of drowning it.
* :class:`TraceLoadGen` — replay of a JSON trace (see
  :func:`save_trace`/:func:`load_trace`), for captured or hand-built
  workloads; the only generator that can mix kernel families in one
  session.

Open-loop generators (Poisson, bursty, trace) are fully replayable:
the same seed yields a byte-identical arrival stream, which is what
makes their serving records comparable across commits (the
``repro_torch.bench.compare`` p99/goodput gate assumes the offered load is
identical on both sides).  The closed-loop generator is seeded but
*reactive by construction* — follow-up arrivals depend on measured
completion times, so its offered stream tracks the serving machine's
speed; gate closed-loop records only across runs of comparable
machines, or prefer open-loop workloads for regression gating.

Pure Python and numpy, copied from the reference package: the same
``numpy.random.Generator`` calls in the same order, so one seed gives the
reference's arrivals exactly.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np

from .requests import Request, RequestResult

__all__ = ["BurstyLoadGen", "ClosedLoopLoadGen", "LoadGen",
           "PoissonLoadGen", "TraceLoadGen", "WORKLOADS", "load_trace",
           "make_loadgen", "save_trace"]


class LoadGen:
    """Base request source: open-loop arrivals + closed-loop reactions.

    ``initial(duration_s)`` returns every arrival known up front (the
    whole stream for open-loop generators, the first request per client
    for closed-loop ones); ``on_complete(result, duration_s)`` lets
    closed-loop generators issue the follow-up request (None for
    open-loop generators, and for completions past the horizon).
    """

    name = "base"

    def initial(self, duration_s: float) -> List[Request]:
        """All arrivals known before the session starts."""
        raise NotImplementedError

    def on_complete(self, result: RequestResult,
                    duration_s: float) -> Optional[Request]:
        """Reactive follow-up arrival, or None (open loop / horizon)."""
        del result, duration_s
        return None


@dataclasses.dataclass
class PoissonLoadGen(LoadGen):
    """Open-loop Poisson arrivals: exponential gaps at ``rate_rps``."""

    kernel: str
    rate_rps: float = 64.0
    size: int = 65536
    dtype: str = "float32"
    seed: int = 0
    name: str = dataclasses.field(default="poisson", init=False)

    def initial(self, duration_s: float) -> List[Request]:
        """The full seeded arrival stream over ``[0, duration_s)``."""
        rng = np.random.default_rng(self.seed)
        out, t, rid = [], 0.0, 0
        while True:
            t += float(rng.exponential(1.0 / self.rate_rps))
            if t >= duration_s:
                return out
            out.append(Request(rid=rid, kernel=self.kernel, arrival_s=t,
                               size=self.size, dtype=self.dtype))
            rid += 1


@dataclasses.dataclass
class BurstyLoadGen(LoadGen):
    """On/off Poisson: ``rate_hi`` for ``duty`` of each period, else lo.

    Models flash crowds: the scheduler sees deep queues during bursts
    and near-idle gaps between them, which is exactly where the p99 and
    the age-trigger of the batch policy earn their keep.
    """

    kernel: str
    rate_hi: float = 256.0
    rate_lo: float = 8.0
    period_s: float = 0.5
    duty: float = 0.5          # fraction of each period spent at rate_hi
    size: int = 65536
    dtype: str = "float32"
    seed: int = 0
    name: str = dataclasses.field(default="bursty", init=False)

    def _rate_at(self, t: float) -> float:
        phase = (t / self.period_s) % 1.0
        return self.rate_hi if phase < self.duty else self.rate_lo

    def initial(self, duration_s: float) -> List[Request]:
        """Thinned non-homogeneous Poisson stream over ``[0, duration_s)``."""
        rng = np.random.default_rng(self.seed)
        peak = max(self.rate_hi, self.rate_lo)
        out, t, rid = [], 0.0, 0
        while True:
            # classic thinning: draw at the peak rate, keep with p = r/peak
            t += float(rng.exponential(1.0 / peak))
            if t >= duration_s:
                return out
            if rng.uniform() <= self._rate_at(t) / peak:
                out.append(Request(rid=rid, kernel=self.kernel, arrival_s=t,
                                   size=self.size, dtype=self.dtype))
                rid += 1


@dataclasses.dataclass
class ClosedLoopLoadGen(LoadGen):
    """``clients`` concurrent clients with exponential think times.

    Each client has exactly one request outstanding: the next one
    arrives ``think`` seconds after the previous completes, so offered
    load tracks service capacity (the latency-throughput curve's
    closed-loop operating point).
    """

    kernel: str
    clients: int = 8
    think_s: float = 0.01
    size: int = 65536
    dtype: str = "float32"
    seed: int = 0
    name: str = dataclasses.field(default="closed", init=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._next_rid = 0

    def _issue(self, at_s: float, client: int) -> Request:
        req = Request(rid=self._next_rid, kernel=self.kernel,
                      arrival_s=at_s, size=self.size, dtype=self.dtype,
                      client=client)
        self._next_rid += 1
        return req

    def initial(self, duration_s: float) -> List[Request]:
        """One seeded staggered first request per client (inside the
        horizon; a stagger past ``duration_s`` never arrives)."""
        self._rng = np.random.default_rng(self.seed)  # replayable restart
        self._next_rid = 0
        firsts = [self._issue(float(self._rng.uniform(0.0, self.think_s)),
                              c) for c in range(self.clients)]
        return [r for r in firsts if r.arrival_s < duration_s]

    def on_complete(self, result: RequestResult,
                    duration_s: float) -> Optional[Request]:
        """The completing client's next request, think time later."""
        think = float(self._rng.exponential(self.think_s))
        at = result.finish_s + think
        if at >= duration_s:
            return None
        return self._issue(at, result.request.client)


@dataclasses.dataclass
class TraceLoadGen(LoadGen):
    """Replay a fixed request list (usually from :func:`load_trace`)."""

    requests: Sequence[Request]
    name: str = dataclasses.field(default="trace", init=False)

    def initial(self, duration_s: float) -> List[Request]:
        """Trace arrivals inside the horizon, re-ridded in arrival order."""
        reqs = sorted((r for r in self.requests if r.arrival_s < duration_s),
                      key=lambda r: (r.arrival_s, r.rid))
        return [dataclasses.replace(r, rid=i) for i, r in enumerate(reqs)]


#: JSON trace format version (``save_trace``/``load_trace``).
TRACE_SCHEMA = 1


def save_trace(path: str, requests: Sequence[Request]) -> str:
    """Write a replayable JSON trace of *requests* (schema 1).

    The on-disk format is ``{"schema": 1, "requests": [{"arrival_s":
    ..., "kernel": ..., "size": ..., "dtype": ..., "client": ...},
    ...]}`` — rids are assigned on load, so traces can be edited or
    concatenated by hand.
    """
    payload = {
        "schema": TRACE_SCHEMA,
        "requests": [{
            "arrival_s": round(r.arrival_s, 9), "kernel": r.kernel,
            "size": r.size, "dtype": r.dtype, "client": r.client,
        } for r in sorted(requests, key=lambda r: (r.arrival_s, r.rid))],
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path


def load_trace(path: str) -> TraceLoadGen:
    """Load a schema-1 JSON trace into a :class:`TraceLoadGen`."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or \
            int(payload.get("schema", 0)) != TRACE_SCHEMA:
        raise ValueError(f"{path}: expected a schema-{TRACE_SCHEMA} trace "
                         f"object")
    raw = payload.get("requests")
    if not isinstance(raw, list):
        raise ValueError(f"{path}: trace missing its 'requests' list")
    reqs = [Request(rid=i, kernel=str(r["kernel"]),
                    arrival_s=float(r["arrival_s"]), size=int(r["size"]),
                    dtype=str(r.get("dtype", "float32")),
                    client=int(r.get("client", 0)))
            for i, r in enumerate(raw)]
    return TraceLoadGen(requests=reqs)


#: Workload names accepted by ``python -m repro_torch.bench serve --workload``.
WORKLOADS = ("poisson", "bursty", "closed", "trace")


def make_loadgen(workload: str, kernel: str, *, rate_rps: float = 64.0,
                 size: int = 65536, dtype: str = "float32", seed: int = 0,
                 trace_path: Optional[str] = None) -> LoadGen:
    """Build the named workload's generator with shared knobs.

    ``rate_rps`` maps onto each model's natural parameter: the Poisson
    rate, the bursty high rate (low = rate/8), or the closed-loop
    client count (``max(1, rate/8)`` clients — a think-time-limited
    approximation of the same offered load).
    """
    if workload == "poisson":
        return PoissonLoadGen(kernel=kernel, rate_rps=rate_rps, size=size,
                              dtype=dtype, seed=seed)
    if workload == "bursty":
        return BurstyLoadGen(kernel=kernel, rate_hi=rate_rps,
                             rate_lo=max(1.0, rate_rps / 8.0), size=size,
                             dtype=dtype, seed=seed)
    if workload == "closed":
        return ClosedLoopLoadGen(kernel=kernel,
                                 clients=max(1, int(rate_rps / 8.0)),
                                 size=size, dtype=dtype, seed=seed)
    if workload == "trace":
        if not trace_path:
            raise ValueError("workload 'trace' needs a trace path")
        gen = load_trace(trace_path)
        # a session publishes one kernel's record: requests the trace
        # holds for *other* kernels must not ride along, or their
        # latencies would be attributed to this kernel's analytics
        mine = [r for r in gen.requests if r.kernel == kernel]
        if not mine:
            raise ValueError(
                f"trace {trace_path!r} holds no requests for kernel "
                f"{kernel!r} (has {sorted({r.kernel for r in gen.requests})})")
        return TraceLoadGen(requests=mine)
    raise ValueError(f"unknown workload {workload!r}; have {WORKLOADS}")
