"""Kernel time measurement: median + IQR over warmed iterations.

On the card every iteration is bracketed by a pair of
``torch.cuda.Event(enable_timing=True)`` records, so a sample is device
time of the launches between them, not the host's enqueue time.  CPU
results are timed with ``perf_counter``.  Which clock applies follows
from where the function's result lives.
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
    return False


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            **kwargs) -> Timing:
    """Per-call time statistics of ``fn(*args, **kwargs)`` in microseconds."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args, **kwargs)
    samples: List[float] = []
    if _on_card(out):
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        samples = [s.elapsed_time(e) * 1e3 for s, e in pairs]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            samples.append((time.perf_counter() - t0) * 1e6)
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
