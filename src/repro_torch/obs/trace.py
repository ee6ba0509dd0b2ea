"""Two-clock span tracing with Chrome-trace export.

Every layer emits :class:`SpanEvent` records into one process-wide
:class:`Tracer`, on whichever clock that layer runs:

* ``wall`` -- host ``time.perf_counter`` time, normalized to the
  tracer's origin (first enable).  ``Dispatcher.run`` launches and
  :func:`repro_torch.core.timing.time_fn` iterations live here.  On the
  card a ``time_fn`` span starts at the host reading taken where its
  start CUDA event was recorded and lasts that iteration's CUDA-event
  sample, so the span is the sample.
* ``virtual`` -- a simulated clock (seconds since session start) for
  replayable timelines: no wall timestamps leak in.

Spans form trees (``depth``/``parent`` via the context-manager stack);
explicitly-timed emissions (:meth:`Tracer.emit`) attach under the
currently-open wall span.

Export is Chrome-trace JSON (the ``traceEvents`` array format Perfetto
and ``chrome://tracing`` load): ``ph:"X"`` complete events with
microsecond ``ts``/``dur``, ``ph:"i"`` instants, one pid per clock.
:func:`write_chrome_trace` serializes with sorted keys and fixed float
rounding, so a file round-trips byte-identically through
:func:`read_chrome_trace` + re-export, and the same events dump to the
same bytes as the reference package's export.

``python -m repro_torch.obs.trace FILE...`` validates trace files.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple)

__all__ = [
    "SpanEvent", "TraceView", "Tracer", "TRACER", "capture",
    "chrome_trace", "dump_chrome_trace", "read_chrome_trace",
    "validate_chrome_trace", "write_chrome_trace",
]

_CLOCKS = ("wall", "virtual")
# one Chrome-trace pid per clock so the two timelines never interleave
# on a shared track (wall ts and virtual ts share no origin)
_CLOCK_PID = {"wall": 1, "virtual": 2}


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One traced interval (or instant) on one clock.

    ``start_us``/``dur_us`` are microseconds -- wall spans relative to
    the tracer's origin, virtual spans relative to session start.
    ``parent`` is the index of the enclosing span in the tracer's event
    list (-1 for roots); ``depth`` is the nesting level.
    """

    name: str
    layer: str
    clock: str
    start_us: float
    dur_us: float
    depth: int = 0
    parent: int = -1
    kind: str = "span"  # "span" | "instant"
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)


class TraceView:
    """A half-open window onto the tracer's event list.

    :func:`capture` yields one of these instead of copying events so
    captures nest: an outer capture (``--trace`` export) and an inner
    one (per-record reconciliation) observe the same underlying list,
    each through its own slice.
    """

    def __init__(self, tracer: "Tracer", start: int):
        self._tracer = tracer
        self._start = start
        self._end: Optional[int] = None

    def close(self) -> None:
        self._end = len(self._tracer.events)

    @property
    def events(self) -> List[SpanEvent]:
        end = len(self._tracer.events) if self._end is None else self._end
        return self._tracer.events[self._start:end]

    def mark(self) -> int:
        """Current position; pair with :meth:`since` for sub-slices."""
        return len(self._tracer.events)

    def since(self, mark: int) -> List[SpanEvent]:
        end = len(self._tracer.events) if self._end is None else self._end
        return self._tracer.events[mark:end]


class Tracer:
    """Process-wide span collector; off by default.

    Wall spans come from :meth:`span` (a context manager timing its
    block) or :meth:`emit` (start and duration measured by the caller,
    so the span is the sample, not a re-measurement).  Virtual spans
    and instants carry explicit simulated-clock times.  Every emission
    path returns at once when disabled, so traced code pays one
    attribute check on the fast path.
    """

    def __init__(self) -> None:
        self.enabled = False
        self.events: List[SpanEvent] = []
        self._stack: List[int] = []  # indices of open wall spans
        self._origin: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    def clear(self) -> None:
        self.events = []
        self._stack = []

    def _now_us(self) -> float:
        if self._origin is None:
            self._origin = time.perf_counter()
        return (time.perf_counter() - self._origin) * 1e6

    def _wall_us(self, t_s: float) -> float:
        """A raw ``perf_counter`` reading as origin-relative us."""
        if self._origin is None:
            self._origin = t_s
        return (t_s - self._origin) * 1e6

    # -- emission ----------------------------------------------------------

    def _parent(self) -> Tuple[int, int]:
        if self._stack:
            idx = self._stack[-1]
            return idx, self.events[idx].depth + 1
        return -1, 0

    @contextlib.contextmanager
    def span(self, name: str, *, layer: str,
             **attrs: Any) -> Iterator[Dict[str, Any]]:
        """Time the block on the wall clock; yields the attrs dict so the
        body can attach results known only once the work ran."""
        if not self.enabled:
            yield {}
            return
        parent, depth = self._parent()
        start = self._now_us()
        live_attrs: Dict[str, Any] = dict(attrs)
        idx = len(self.events)
        # placeholder so children opened inside the block can point at a
        # real parent index; finalized (immutably replaced) on exit
        self.events.append(SpanEvent(name=name, layer=layer, clock="wall",
                                     start_us=start, dur_us=0.0,
                                     depth=depth, parent=parent,
                                     attrs=live_attrs))
        self._stack.append(idx)
        try:
            yield live_attrs
        finally:
            self._stack.pop()
            dur = self._now_us() - start
            self.events[idx] = dataclasses.replace(
                self.events[idx], dur_us=dur, attrs=dict(live_attrs))

    def emit(self, name: str, *, layer: str, start_s: float, dur_s: float,
             **attrs: Any) -> None:
        """A wall span the caller already measured (``start_s`` a
        perf_counter reading, ``dur_s`` seconds), recorded verbatim so
        span duration == sample."""
        if not self.enabled:
            return
        parent, depth = self._parent()
        self.events.append(SpanEvent(
            name=name, layer=layer, clock="wall",
            start_us=self._wall_us(start_s), dur_us=dur_s * 1e6,
            depth=depth, parent=parent, attrs=dict(attrs)))

    def virtual(self, name: str, *, layer: str, start_s: float,
                dur_s: float, **attrs: Any) -> None:
        """A span on the virtual clock (seconds since session start); no
        wall time is consulted, keeping traces replayable."""
        if not self.enabled:
            return
        self.events.append(SpanEvent(
            name=name, layer=layer, clock="virtual",
            start_us=start_s * 1e6, dur_us=dur_s * 1e6,
            depth=0, parent=-1, attrs=dict(attrs)))

    def instant(self, name: str, *, layer: str, at_s: float,
                clock: str = "virtual", **attrs: Any) -> None:
        """A zero-duration mark."""
        if not self.enabled:
            return
        if clock not in _CLOCKS:
            raise ValueError(f"unknown clock {clock!r}")
        at_us = at_s * 1e6 if clock == "virtual" else self._wall_us(at_s)
        parent, depth = (self._parent() if clock == "wall" else (-1, 0))
        self.events.append(SpanEvent(
            name=name, layer=layer, clock=clock, start_us=at_us,
            dur_us=0.0, depth=depth, parent=parent, kind="instant",
            attrs=dict(attrs)))


TRACER = Tracer()


@contextlib.contextmanager
def capture() -> Iterator[TraceView]:
    """Enable the process tracer for the block; yield a view of the
    events it emits.  Reentrant: nested captures share the tracer and
    see only their own slice; the outermost enable/disable wins."""
    was_enabled = TRACER.enabled
    if not was_enabled:
        TRACER.enabled = True
        if TRACER._origin is None:
            TRACER._origin = time.perf_counter()
    view = TraceView(TRACER, len(TRACER.events))
    try:
        yield view
    finally:
        view.close()
        if not was_enabled:
            TRACER.enabled = False


# --------------------------------------------------------------------------
# Chrome-trace JSON export / import / validation
# --------------------------------------------------------------------------

def _round6(x: float) -> float:
    """Fixed us rounding for export: sub-picosecond residue from the
    s -> us conversion must not make two identical timelines differ."""
    return round(float(x), 6)


def chrome_trace(events: Sequence[SpanEvent],
                 meta: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Events as a Chrome-trace/Perfetto ``traceEvents`` object.

    ``pid`` separates the clocks (1=wall, 2=virtual); ``tid`` is the
    span's depth so nested spans stack visually.  ``args`` carries the
    span attrs plus the bookkeeping (layer, clock, parent index) needed
    to audit the tree after import.
    """
    out: List[Dict[str, Any]] = []
    for clock in _CLOCKS:
        if any(e.clock == clock for e in events):
            out.append({"ph": "M", "name": "process_name",
                        "pid": _CLOCK_PID[clock], "tid": 0, "ts": 0,
                        "args": {"name": f"{clock} clock"}})
    for i, e in enumerate(events):
        ev: Dict[str, Any] = {
            "name": e.name,
            "cat": e.layer,
            "pid": _CLOCK_PID[e.clock],
            "tid": e.depth,
            "ts": _round6(e.start_us),
            "args": dict(e.attrs, layer=e.layer, clock=e.clock,
                         parent=e.parent, index=i),
        }
        if e.kind == "instant":
            ev["ph"] = "i"
            ev["s"] = "p"
        else:
            ev["ph"] = "X"
            ev["dur"] = _round6(e.dur_us)
        out.append(ev)
    payload: Dict[str, Any] = {
        "displayTimeUnit": "ms",
        "traceEvents": out,
    }
    if meta:
        payload["otherData"] = dict(meta)
    return payload


def dump_chrome_trace(payload: Mapping[str, Any]) -> str:
    """The one serialization: sorted keys, compact separators, trailing
    newline -- byte-deterministic for identical payloads."""
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")) + "\n"


def write_chrome_trace(path: str, events: Sequence[SpanEvent],
                       meta: Optional[Mapping[str, Any]] = None) -> None:
    """Export *events* to *path* through :func:`dump_chrome_trace`."""
    with open(path, "w") as f:
        f.write(dump_chrome_trace(chrome_trace(events, meta)))


def read_chrome_trace(path: str) -> Dict[str, Any]:
    """Parse + validate a trace file; returns the payload dict.

    ``dump_chrome_trace(read_chrome_trace(p))`` reproduces the file's
    bytes exactly (JSON floats round-trip).
    """
    with open(path) as f:
        payload = json.load(f)
    problems = validate_chrome_trace(payload)
    if problems:
        raise ValueError(f"{path}: invalid Chrome trace: "
                         + "; ".join(problems[:5]))
    return payload


def validate_chrome_trace(payload: Any) -> List[str]:
    """Structural problems with a Chrome-trace payload ([] == valid)."""
    problems: List[str] = []
    if not isinstance(payload, Mapping):
        return ["payload is not an object"]
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    if not events:
        problems.append("traceEvents is empty")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, Mapping):
            problems.append(f"{where} is not an object")
            continue
        for field in ("ph", "name", "pid", "tid"):
            if field not in ev:
                problems.append(f"{where} missing {field!r}")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "C"):
            problems.append(f"{where} has unsupported ph={ph!r}")
        if ph in ("X", "i") and not isinstance(
                ev.get("ts"), (int, float)):
            problems.append(f"{where} missing numeric ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)):
                problems.append(f"{where} (ph=X) missing numeric dur")
            elif dur < 0:
                problems.append(f"{where} has negative dur")
    return problems


def _main(argv: List[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch.obs.trace FILE [FILE ...]\n"
              "Validate Chrome-trace JSON files.")
        return 0 if argv else 2
    status = 0
    for path in argv:
        try:
            payload = read_chrome_trace(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"FAIL {path}: {e}")
            status = 1
            continue
        events = payload["traceEvents"]
        spans = sum(1 for e in events if e.get("ph") == "X")
        instants = sum(1 for e in events if e.get("ph") == "i")
        clocks = sorted({e.get("args", {}).get("clock") for e in events
                         if e.get("ph") in ("X", "i")})
        print(f"OK   {path}: {spans} spans, {instants} instants, "
              f"clocks={clocks}")
    return status


if __name__ == "__main__":  # pragma: no cover - exercised via the CLI
    import sys
    sys.exit(_main(sys.argv[1:]))
