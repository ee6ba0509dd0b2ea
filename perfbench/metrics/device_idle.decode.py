"""``device_idle.decode``: the share (%) of an unprofiled step in which
the card idles: one less the device-busy time per step of the profiled
stretch (the union of its kernels, which run as fast under the profiler)
over the median step gap of the window's steps before it (CUDA events).
The profiled stretch itself is paced by the profiler's host overhead, so
its own idle share (``device.busy_s`` / ``window_s``) reads high."""
from perfbench.harness.core import percentile


def read(run):
    tr, rec = run.trace, run.record
    steps = tr.count("pb.step") if tr is not None else 0
    gaps = rec.get("itl_ms", [])[:rec.get("pre_steps", 0)]
    if steps <= 0 or not gaps:
        return None
    busy_ms = 1e3 * tr.busy_s(clip=False) / steps
    return 100.0 * (1.0 - busy_ms / percentile(gaps, 50))
