"""Kernel time measurement: median + IQR over warmed iterations.

On the card every iteration is bracketed by a pair of
``torch.cuda.Event(enable_timing=True)`` records, so a sample is device
time of the launches between them, not the host's enqueue time.  CPU
work is timed with ``perf_counter``.  Which clock applies follows from
where the arguments live or, for a function of no tensor argument (a
closure), from where the first timed call's result lives.

When the :mod:`repro_torch.obs` tracer is enabled, every timed iteration
is also emitted as a wall-clock span *after* the measurement loop,
carrying its sample verbatim: on the card the span starts at the host
``perf_counter`` reading taken where the iteration's start event was
recorded and lasts the CUDA-event sample.  Nothing is added inside the
timed loop, and the span median equals ``Timing.median_us``.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, List, NamedTuple, Tuple

import torch

from ..obs.trace import TRACER

__all__ = ["Timing", "busy_us", "device_busy_us", "queued_event_us",
           "time_fn", "timing_of"]


class Timing(NamedTuple):
    """One timing measurement: median + spread + the raw samples."""

    median_us: float  # median time per call, microseconds
    iqr_us: float     # interquartile range (q75 - q25), microseconds
    iters: int        # timed iterations behind the statistics
    samples_us: Tuple[float, ...] = ()  # raw per-iteration times, in order


def _quantile(sorted_times: List[float], q: float) -> float:
    """Linear-interpolated quantile of an ascending-sorted sample."""
    idx = q * (len(sorted_times) - 1)
    lo, hi = math.floor(idx), math.ceil(idx)
    frac = idx - lo
    return sorted_times[lo] * (1.0 - frac) + sorted_times[hi] * frac


def _on_card(out: Any) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_card(o) for o in out)
    if isinstance(out, dict):
        return any(_on_card(o) for o in out.values())
    return False


def _has_tensor(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    if isinstance(x, (tuple, list)):
        return any(_has_tensor(o) for o in x)
    if isinstance(x, dict):
        return any(_has_tensor(o) for o in x.values())
    return False


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            label: str = "iteration", layer: str = "timing",
            **span_attrs) -> Timing:
    """Per-call time statistics of ``fn(*args)`` in microseconds.

    The reference's signature: ``warmup`` untimed calls (0 allowed), then
    ``iters`` timed ones.  *label* / *layer* / extra keywords only name
    the spans emitted when the obs tracer is on; they are never passed to
    ``fn`` and never affect the measurement.  Pass keyword arguments of
    ``fn`` through a closure.
    """
    for _ in range(warmup):
        fn(*args)
    # card or host: from the arguments, else from the first timed call
    card = _on_card(args) if _has_tensor(args) else None
    if card is not False and torch.cuda.is_available():
        torch.cuda.synchronize()
    # (host start, host seconds, CUDA event pair or None) per iteration
    runs = []
    for _ in range(iters):
        events = None
        if card is not False and torch.cuda.is_available():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        if events is not None:
            events[1].record()
        if card is None:
            card = _on_card(out)
        runs.append((t0, dt, events))
    if card:
        torch.cuda.synchronize()
        samples = [s.elapsed_time(e) * 1e3 for _, _, (s, e) in runs]
    else:
        samples = [dt * 1e6 for _, dt, _ in runs]
    if TRACER.enabled:
        # emitted after the loop so tracing adds nothing inside the timed
        # region; each span carries its sample verbatim
        for i, ((t0, _, _), us) in enumerate(zip(runs, samples)):
            TRACER.emit(label, layer=layer, start_s=t0, dur_s=us * 1e-6,
                        iter=i, **span_attrs)
    return timing_of(samples)


def timing_of(samples_us) -> Timing:
    """The median / IQR statistics of per-iteration samples (microseconds,
    in the order taken)."""
    samples = [float(s) for s in samples_us]
    times = sorted(samples)
    return Timing(median_us=_quantile(times, 0.5),
                  iqr_us=_quantile(times, 0.75) - _quantile(times, 0.25),
                  iters=len(samples), samples_us=tuple(samples))


def busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals: the time in which
    at least one of them runs, overlaps counted once."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def queued_event_us(fn: Callable, calls: int = 20) -> float:
    """Time per call of ``calls`` back-to-back calls of ``fn`` between one
    pair of CUDA events, after one untimed call.

    Where the host enqueues a call faster than the card runs it, the calls
    queue behind each other and this is the card's time per call (the
    host's enqueue of the first call, counted once, aside); otherwise it
    is the host's.  One event pair for many calls, and no profiler: the
    per-shard times of a sharded call, where short back-to-back
    torch.profiler sessions dropped kernels.
    """
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def device_busy_us(fn: Callable, *args, calls: int = 20, **kwargs) -> float:
    """Device time per call of ``fn`` on the card, from torch.profiler.

    The union of the intervals in which any kernel that the calls launch
    runs, over ``calls`` back-to-back calls, divided by ``calls``: kernels
    that overlap (a dependent launched before its predecessor ends) count
    once, and the gaps between calls not at all.  0.0 if the profiler saw
    no kernel.
    """
    fn(*args, **kwargs)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args, **kwargs)
        torch.cuda.synchronize()
    return busy_us((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / calls
