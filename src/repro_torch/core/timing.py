"""Kernel time measurement: median + IQR over warmed iterations.

On the card every iteration is bracketed by a pair of
``torch.cuda.Event(enable_timing=True)`` records, so a sample is device
time of the launches between them, not the host's enqueue time.  CPU
work is timed with ``perf_counter``.  Which clock applies follows from
where the arguments live or, for a function of no tensor argument (a
closure), from where the first timed call's result lives.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, List, NamedTuple, Tuple

import torch

__all__ = ["Timing", "busy_us", "device_busy_us", "time_fn"]


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
    ``iters`` timed ones.  *label* / *layer* / extra keywords name the
    spans of a tracer and are never passed to ``fn``; until the port has
    one they affect nothing.  Pass keyword arguments of ``fn`` through a
    closure.
    """
    del label, layer, span_attrs
    for _ in range(warmup):
        fn(*args)
    # card or host: from the arguments, else from the first timed call
    card = _on_card(args) if _has_tensor(args) else None
    if card is not False and torch.cuda.is_available():
        torch.cuda.synchronize()
    samples: List[float] = []
    pairs = []
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
        if card:
            pairs.append(events)
        else:
            samples.append(dt * 1e6)
    if pairs:
        torch.cuda.synchronize()
        samples = [s.elapsed_time(e) * 1e3 for s, e in pairs]
    times = sorted(samples)
    return Timing(median_us=_quantile(times, 0.5),
                  iqr_us=_quantile(times, 0.75) - _quantile(times, 0.25),
                  iters=iters, samples_us=tuple(samples))


def busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals: the time in which
    at least one of them runs, overlaps counted once."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


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
