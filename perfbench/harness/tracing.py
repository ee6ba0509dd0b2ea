"""The traced sub-window and what is read from its trace.

A traced run (``--trace 1``) profiles one steady stretch of its window
with ``torch.profiler`` (host and device activity): it synchronises,
starts the profiler, runs ``lead`` units (passes or decode steps) so that
the card's queue fills again, opens the ``pb.window`` range, runs
``units`` more, synchronises and stops.  The window's idle share is read
inside ``pb.window``; the kernels' shares over every unit profiled.  Only
inside that stretch do the drivers open their own ranges (``pb.<name>``,
``torch.profiler.record_function``) around the calls into each layer, so
an untraced window runs no range at all.

The trace is exported as Chrome trace JSON, kept gzipped under the run's
output directory, and read back into a :class:`Trace`: every device
operation with the benchmark range that was innermost on the host when
it was launched (found through the launch's correlation id, or its
external id), and the benchmark's own host ranges.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import os
import pathlib
import shutil
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Trace categories of operations that run on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset")
#: Trace categories of the host's launch calls (CUDA runtime or driver).
LAUNCH_CATS = ("cuda_runtime", "cuda_driver", "runtime", "driver")
WINDOW = "pb.window"
PREFIX = "pb."
#: The label of host time inside no benchmark range (the driver's loop).
OUTSIDE = "between ranges"


@dataclasses.dataclass
class Op:
    """One device operation: times in microseconds on the trace's clock."""

    name: str
    kind: str
    start: float
    end: float
    range: Optional[str]


@dataclasses.dataclass
class Trace:
    """The traced sub-window: its bounds, device operations, the
    benchmark's host ranges and the host's ops (name, start, end), with the
    driver's notes (work per range)."""

    t0: float
    t1: float
    ops: List[Op]
    ranges: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    notes: dict

    @property
    def window_s(self) -> float:
        """Length of the traced window in seconds."""
        return (self.t1 - self.t0) / 1e6

    @property
    def unattributed(self) -> int:
        """Device operations profiled with no benchmark range."""
        return sum(1 for op in self.ops if op.range is None)

    def select(self, prefixes: Optional[Sequence[str]] = None) -> List[Op]:
        """Ops whose range starts with one of ``prefixes`` (all: None)."""
        if prefixes is None:
            return list(self.ops)
        return [op for op in self.ops
                if op.range is not None and op.range.startswith(
                    tuple(prefixes))]

    def busy_s(self, prefixes: Optional[Sequence[str]] = None,
               clip: bool = True) -> float:
        """Seconds in which at least one selected op ran (their union),
        clipped to the window unless ``clip`` is False."""
        lo, hi = (self.t0, self.t1) if clip else (float("-inf"),
                                                   float("inf"))
        spans = sorted((max(op.start, lo), min(op.end, hi))
                       for op in self.select(prefixes))
        total, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def count(self, prefix: str) -> int:
        """Host ranges whose name starts with ``prefix``."""
        return sum(1 for name, _, _ in self.ranges if name.startswith(prefix))

    def work(self, prefixes: Sequence[str]) -> Tuple[float, float]:
        """(bytes, operations) the driver noted for the ranges starting
        with one of ``prefixes``."""
        b = f = 0.0
        for name, (nb, nf) in self.notes.get("work", {}).items():
            if name.startswith(tuple(prefixes)):
                b, f = b + nb, f + nf
        return b, f

    def top_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations that took most time, by name."""
        by: Dict[str, float] = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0.0) + (op.end - op.start) / 1e6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest stretches of the window with no device
        operation, each named by what the host was doing in its middle:
        the benchmark range, then the host op, open there."""
        spans = sorted((op.start, op.end) for op in self.ops
                       if op.end > self.t0 and op.start < self.t1)
        gaps, cursor = [], self.t0
        for s, e in spans:
            if s > cursor:
                gaps.append((cursor, min(s, self.t1)))
            cursor = max(cursor, e)
        if cursor < self.t1:
            gaps.append((cursor, self.t1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        mids = [(i, (a + b) / 2) for i, (a, b) in enumerate(gaps)]
        in_range = _innermost(self.ranges, mids)
        in_host = _innermost(self.host_ops, mids)
        return [[in_range.get(i, OUTSIDE) + (f"/{in_host[i]}" if i in in_host
                                             else ""), (b - a) / 1e6]
                for i, (a, b) in enumerate(gaps)]


def _innermost(intervals: List[Tuple[str, float, float]],
               queries: List[Tuple[int, float]]) -> Dict[int, str]:
    """For each (key, time) query, the name of the innermost interval
    containing the time (intervals nest, as host ranges on one thread
    do)."""
    order = sorted(intervals, key=lambda r: (r[1], -r[2]))
    out, stack, i = {}, [], 0
    for key, ts in sorted(queries, key=lambda q: q[1]):
        while i < len(order) and order[i][1] <= ts:
            while stack and stack[-1][2] < order[i][1]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][2] < ts:
            stack.pop()
        if stack:
            out[key] = stack[-1][0]
    return out


def parse(events: Iterable[dict], notes: Optional[dict] = None) -> Trace:
    """A :class:`Trace` from Chrome trace events (Kineto's export)."""
    events = [e for e in events if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat", "").lower() in ("user_annotation", "cpu_op")]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} range")
    w = win[0]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    main = (w.get("pid"), w.get("tid"))
    ranges, host_ops, launch_ts, ext_ts = [], [], {}, {}
    devs = []
    for e in events:
        cat = e.get("cat", "").lower()
        ts = float(e.get("ts", 0.0))
        end = ts + float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            devs.append(e)
            continue
        if cat in LAUNCH_CATS and "correlation" in args:
            launch_ts[args["correlation"]] = ts
            continue
        if cat in ("user_annotation", "cpu_op"):
            if args.get("External id") is not None:
                ext_ts.setdefault(args["External id"], ts)
            if (e.get("pid"), e.get("tid")) != main:
                continue
            name = e.get("name", "")
            if cat == "user_annotation" and name.startswith(PREFIX):
                if name != WINDOW:
                    ranges.append((name, ts, end))
            elif cat == "cpu_op":
                host_ops.append((name, ts, end))
    queries = []
    for i, e in enumerate(devs):
        args = e.get("args") or {}
        ts = launch_ts.get(args.get("correlation"))
        if ts is None:
            ts = ext_ts.get(args.get("External id"))
        if ts is not None:
            queries.append((i, ts))
    in_range = _innermost(ranges, queries)
    ops = []
    for i, e in enumerate(devs):
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        cat = e.get("cat", "").lower()
        ops.append(Op(e.get("name", ""), "kernel" if cat == "kernel"
                      else cat, s, end, in_range.get(i)))
    return Trace(t0, t1, ops, sorted(ranges, key=lambda r: r[1]), host_ops,
                 dict(notes or {}))


class SubWindow:
    """Profiles one steady stretch of a traced run's window.

    The driver calls :meth:`tick` before each unit of work (a pass, a
    decode step) with the seconds since the window began, opens its own
    ranges with :meth:`range`, and keeps its loop going while
    :attr:`open`.  ``hooks`` are context managers entered while the
    stretch is profiled (a driver's wrappers around a layer's calls).
    """

    def __init__(self, torch, *, enabled: bool, after_s: float, units: int,
                 lead: int, device: str, out_dir: pathlib.Path,
                 stem: str = "trace"):
        self.torch = torch
        self.enabled = enabled
        self.after_s = after_s
        self.units = units
        self.lead = lead
        self.device = device
        self.out_dir = out_dir
        self.stem = stem
        self.state = "wait" if enabled else "off"
        self.notes: dict = {"work": {}}
        self.hooks: List = []
        self.trace: Optional[Trace] = None
        self.opened_at: Optional[float] = None
        self._prof = None
        self._stack: Optional[contextlib.ExitStack] = None
        self._done_units = 0

    @property
    def open(self) -> bool:
        """Whether the stretch is being profiled now."""
        return self.state == "open"

    def _sync(self) -> None:
        if self.device.startswith("cuda"):
            self.torch.cuda.synchronize()

    def range(self, name: str, work: Optional[Tuple[float, float]] = None):
        """A ``record_function`` range while profiling (else a no-op);
        ``work`` (bytes, operations) is added to the range's notes."""
        if self.state != "open":
            return contextlib.nullcontext()
        if work is not None:
            acc = self.notes["work"].setdefault(name, [0.0, 0.0])
            acc[0] += float(work[0])
            acc[1] += float(work[1])
        return self.torch.profiler.record_function(name)

    def tick(self, elapsed: float) -> None:
        """Called before each unit: opens the stretch once ``after_s`` of
        the window has passed, closes it after ``units`` units."""
        if self.state == "wait" and elapsed >= self.after_s:
            self._start()
        elif self.state == "open":
            self._done_units += 1
            if self._done_units == self.lead:
                self._stack.enter_context(
                    self.torch.profiler.record_function(WINDOW))
            if self._done_units >= self.lead + self.units:
                self.close()

    def _start(self) -> None:
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.opened_at = time.perf_counter()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._stack = contextlib.ExitStack()
        self.state = "open"
        for hook in self.hooks:
            self._stack.enter_context(hook)
        if self.lead == 0:
            self._stack.enter_context(torch.profiler.record_function(WINDOW))

    def close(self) -> None:
        """End the stretch: synchronise, stop, export and read the trace."""
        if self.state != "open":
            return
        self._sync()
        self._stack.close()
        self._prof.stop()
        self.state = "done"
        out = self.out_dir
        out.mkdir(parents=True, exist_ok=True)
        raw = out / f"{self.stem}.json"
        self._prof.export_chrome_trace(str(raw))
        self._prof = None
        with open(raw) as f:
            doc = json.load(f)
        with open(raw, "rb") as src, \
                gzip.open(out / f"{self.stem}.json.gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.unlink(raw)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        self.trace = parse(events, self.notes)
