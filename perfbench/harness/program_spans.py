"""The program's own ranges in a traced run's kept trace.

While a profiler records, the port opens ``record_function`` ranges of
its own (``repro_torch.obs.trace``): ``model.decode_step``,
``model.attention``, ``model.mlp``, ``model.head`` in a decode step,
``dispatch.<kernel>`` and ``launch.<kernel>.<engine>`` around each call
through its dispatcher.  ``tracing.parse`` keeps only the benchmark's
``pb.*`` ranges; this reads the kept trace again (once per process) for
the program's, and gives each device operation the innermost program
range that was open on the host when it was launched, by the launch's
correlation id or its external id, as ``tracing.parse`` does.  Nested
ranges are selected by prefix: ``dispatch.attention`` and
``launch.attention.`` together are everything launched inside a
flash-decode dispatch.

A program that opens no such range (an older checkout) leaves every
reader here with nothing to read: they return None.
"""
from __future__ import annotations

import gzip
import json
import pathlib
from typing import Callable, Dict, Optional, Sequence, Tuple

from perfbench.costs import bound_s

from . import core, tracing

#: Name prefixes of the program's ranges.
PREFIXES = ("model.", "dispatch.", "launch.")


def parse(events: Sequence[dict]) -> Optional[tracing.Trace]:
    """A :class:`tracing.Trace` of the program's ranges: each device
    operation's ``range`` is the innermost program range at its launch
    (None where there is none), ``ranges`` the main thread's program
    ranges; None without a ``pb.window`` range."""
    events = [e for e in events if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == tracing.WINDOW
           and e.get("cat", "").lower() in ("user_annotation", "cpu_op")]
    if not win:
        return None
    w = win[0]
    main = (w.get("pid"), w.get("tid"))
    ranges, launch_ts, ext_ts, devs = [], {}, {}, []
    for e in events:
        cat = e.get("cat", "").lower()
        ts = float(e.get("ts", 0.0))
        args = e.get("args") or {}
        if cat in tracing.DEVICE_CATS:
            devs.append(e)
        elif cat in tracing.LAUNCH_CATS and "correlation" in args:
            launch_ts[args["correlation"]] = ts
        elif cat in ("user_annotation", "cpu_op"):
            if args.get("External id") is not None:
                ext_ts.setdefault(args["External id"], ts)
            name = e.get("name", "")
            if cat == "user_annotation" and name.startswith(PREFIXES) \
                    and (e.get("pid"), e.get("tid")) == main:
                ranges.append((name, ts, ts + float(e.get("dur", 0.0))))
    queries = []
    for i, e in enumerate(devs):
        args = e.get("args") or {}
        ts = launch_ts.get(args.get("correlation"))
        if ts is None:
            ts = ext_ts.get(args.get("External id"))
        if ts is not None:
            queries.append((i, ts))
    inner = tracing._innermost(ranges, queries)
    ops = [tracing.Op(e.get("name", ""), e.get("cat", "").lower(),
                      float(e["ts"]),
                      float(e["ts"]) + float(e.get("dur", 0.0)),
                      inner.get(i)) for i, e in enumerate(devs)]
    t0 = float(w["ts"])
    return tracing.Trace(t0, t0 + float(w["dur"]), ops,
                         sorted(ranges, key=lambda r: r[1]), [], {})


_PARSED: Dict[Tuple[str, int, int], Optional[tracing.Trace]] = {}


def _parsed(path: pathlib.Path) -> Optional[tracing.Trace]:
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _PARSED:
        with gzip.open(path, "rt") as f:
            doc = json.load(f)
        _PARSED[key] = parse(doc["traceEvents"] if isinstance(doc, dict)
                             else doc)
    return _PARSED[key]


def spans(run) -> Optional[tracing.Trace]:
    """This run's program ranges (:func:`parse`): from the kept trace
    under the cell's output directory whose ``pb.window`` range starts
    where the run's trace does (the newest first), or None where no file
    matches or it holds no program range."""
    tr = run.trace
    out = core.OUT / run.cell
    if tr is None or not out.is_dir():
        return None
    files = sorted(out.glob("*.trace.json.gz"),
                   key=lambda p: p.stat().st_mtime_ns, reverse=True)
    for path in files:
        got = _parsed(path)
        if got is not None and got.t0 == tr.t0:
            return got if got.ranges else None
    return None


def decode_work(run, work_of: Callable[[int], Tuple[float, float]]
                ) -> Tuple[float, float]:
    """(bytes, operations) of the profiled decode steps: ``work_of``
    (a step's at its kv_len) summed over the steps after the
    ``pre_steps`` before the profiler opened, one per
    ``model.decode_step`` range ((0, 0) without program ranges)."""
    sp = spans(run)
    if sp is None:
        return 0.0, 0.0
    pre = run.record.get("pre_steps", 0)
    kv_lens = run.record.get("kv_lens", [])[
        pre:pre + sp.count("model.decode_step")]
    nbytes = flops = 0.0
    for kv in kv_lens:
        b, f = work_of(kv)
        nbytes, flops = nbytes + b, flops + f
    return nbytes, flops


def roofline(run, prefixes: Sequence[str], work: Tuple[float, float]
             ) -> Optional[float]:
    """The share (%) of its bound that ``work`` (bytes, operations)
    reached in the device operations whose innermost program range
    starts with one of ``prefixes``: the frozen bound over the union of
    their device time.  None without a trace, a peak for this card,
    program ranges, work or device time, or where a device operation of
    the window has no benchmark range (the time would then be short)."""
    tr = run.trace
    if tr is None or run.peaks is None or tr.unattributed:
        return None
    sp = spans(run)
    if sp is None:
        return None
    busy = sp.busy_s(prefixes, clip=False)
    if work[0] <= 0 or busy <= 0:
        return None
    return 100.0 * bound_s(work[0], work[1], run.peaks) / busy
