"""Registry-driven kernel sweep: kernel x engine x size x dtype.

Every ``EngineOp`` of ``repro_torch.kernels.registry`` is swept at two
size sets:

* the reference's ``bench_sizes`` (x ``dtypes``), kept for parity with
  the reference's records.  On the card they are at most 2^22 elements
  and fit in the 50 MiB L2, so their records carry ``l2_resident: true``
  and their shares are not HBM shares;
* the STREAM points (:func:`stream_points`), where every array is at
  least 4x the L2: SCALE / Triad / AXPY at float32 2^26 and bfloat16
  2^27, SpMV at 8192, the stencils 2d5pt 8192^2 and 3d7pt 512^3 at
  t = 3, flash-decode at B4 KH8 G4 Dh128, S = 32768, kv_len = 7S/8.

Per point the inputs come from a seeded numpy generator and the Advice
from an advisor on the record's own hardware model.  Each engine's
output is held against the oracle (``max_err``), and the engine's kernel
is timed by ``time_fn`` (``us_per_call``, ``iqr_us``, ``iters``): it is
called through the family's engine function, not ``Dispatcher.run``, so
no traced ``launch`` span (which waits for the card) opens inside the
timed loop.  The spans of that timing make the record's ``trace`` block.
The oracle is timed into ``ref_us_per_call``, the reference's meaning of
that field.  On the card every engine also gets torch.profiler's device
time per call (``profiler_device_us``).

With a tuned cache (``tuned=``, ``--tuned FILE``) every engine is checked
and timed with the tile the cache holds for its (kernel, engine, dtype,
hardware model), and the record's ``tile_config`` carries the params with
the tuner's own ``tuned_us`` / ``default_us`` (the reference's
``_tile_config_field``); without one, or on a cache miss, it is null and
the static tiles run.

The sweep is single-device: ``mesh_shape`` / ``shard_spec`` /
``mesh_exec`` are written as null (the mesh legs wait for ROADMAP Queue 1
item 13).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..carry import cast
from ..core.advisor import EngineAdvisor
from ..core.dispatch import DEFAULT_DISPATCHER, Dispatcher, TuningPolicy
from ..core.hw import HardwareSpec, spec_for_device_name
from ..core.timing import device_busy_us
from ..kernels import registry
from ..obs.counters import roofline_sample
from ..obs.trace import capture, write_chrome_trace
from .common import bench_env, time_fn, write_json

__all__ = ["SEED", "Point", "bound_work", "default_hw", "records_for",
           "rows", "stream_points", "sweep_points", "tracer_overhead"]

SEED = 0
#: (warmup, timed) calls per measurement: on the card the CUDA-event
#: median of 20 calls; on the CPU the reference's time_fn defaults.
_COUNTS = {"cuda": (3, 20), "cpu": (2, 5)}
#: Flash-decode's STREAM shape: Mistral-NeMo-12B's decode heads (G = 32 /
#: 8 query heads per KV head, Dh = 128) over a long cache.
_ATTN_STREAM = {"b": 4, "kh": 8, "g": 4, "dh": 128, "s": 32768}


@dataclasses.dataclass
class Point:
    """One sweep point: the record's size, its dtype and the call."""

    size: int
    dtype: str
    args: tuple
    kwargs: dict


def default_hw(device: str) -> HardwareSpec:
    """The card's own spec on ``"cuda"``, else the default advisor's."""
    if device == "cuda":
        return spec_for_device_name(torch.cuda.get_device_name(0))
    return DEFAULT_DISPATCHER.hw


def sweep_points(op, rng: np.random.Generator, device: str,
                 sizes: Optional[Sequence[int]] = None) -> Iterator[Point]:
    """The reference's sweep: every size (default ``op.bench_sizes``) x
    ``op.dtypes``, in its order, so one seed gives its inputs."""
    for size in (op.bench_sizes if sizes is None else sizes):
        for dtype in op.dtypes:
            args, kw = op.make_inputs(rng, size, dtype, device)
            yield Point(size, dtype, args, kw)


def _normal(rng: np.random.Generator, shape: Tuple[int, ...], dtype: str,
            device: str) -> torch.Tensor:
    """A seeded standard-normal draw of ``shape``, rounded to ``dtype``."""
    return cast(rng.standard_normal(shape), dtype, device)


def stream_points(op, rng: np.random.Generator,
                  device: str) -> Iterator[Point]:
    """The STREAM points of one family (module docstring), built one at
    a time so only one point's inputs need to be alive."""
    if op.name in ("scale", "triad", "axpy"):
        for dtype, n in (("float32", 2**26), ("bfloat16", 2**27)):
            args, kw = op.make_inputs(rng, n, dtype, device)
            yield Point(n, dtype, args, kw)
    elif op.name == "spmv":
        args, kw = op.make_inputs(rng, 8192, "float32", device)
        yield Point(8192, "float32", args, kw)
    elif op.name == "stencil":
        from ..kernels.stencil.defs import TABLE3_DEPTH, suite
        args, kw = op.make_inputs(rng, 8192, "float32", device)
        yield Point(8192, "float32", args, kw)
        del args, kw
        u3 = _normal(rng, (512, 512, 512), "float32", device)
        yield Point(512, "float32", (u3, suite()["3d7pt"]),
                    {"steps": TABLE3_DEPTH["3d7pt"]})
    elif op.name == "attention":
        p = _ATTN_STREAM
        for dtype in ("float32", "bfloat16"):
            q = _normal(rng, (p["b"], p["kh"], p["g"], p["dh"]), dtype,
                        device)
            k, v = (_normal(rng, (p["b"], p["s"], p["kh"], p["dh"]), dtype,
                            device) for _ in range(2))
            yield Point(p["s"], dtype, (q, k, v, p["s"] - p["s"] // 8), {})
            del q, k, v
    else:
        raise KeyError(f"no STREAM point for kernel {op.name!r}")


def bound_work(name: str, args: tuple, traits) -> Tuple[float, float]:
    """(bytes, operations) the function needs on these inputs.

    Flash-decode reads the K and V rows of min(kv_len, S) positions (all
    S when kv_len <= 0, where the output is the mean of V), q once and
    writes the output once, where the advisor's traits count every cache
    position.  Every other kernel: the advisor's traits.
    """
    if name != "attention":
        return float(traits.traffic_bytes), float(traits.work_flops)
    q, k, _, kv_len = args
    b, kh, g, dh = q.shape
    s = k.shape[1]
    used = min(kv_len, s) if kv_len >= 1 else s
    esize = k.element_size()
    traffic = (2 * b * used * kh * dh + 2 * q.numel()) * esize
    return float(traffic), 4.0 * b * kh * g * used * dh


def _tile_config_field(dispatcher: Dispatcher, op, engine: str,
                       dtype: str) -> Optional[dict]:
    """The tuned-tile evidence for one sweep point, or None (defaults):
    the params with the tuner's own ``tuned_us`` (the cache's
    ``best_us``) and ``default_us``, so the report renders the
    tuned-vs-default delta without re-timing anything."""
    entry = dispatcher.tuning.lookup(op.name, engine, dtype,
                                     dispatcher.hw.name)
    if entry is None:
        return None
    return {
        "params": {k: int(v) for k, v in sorted(entry.params.items())},
        "tuned_us": round(entry.best_us, 1),
        "default_us": round(entry.default_us, 1),
        "source": entry.source,
    }


def _shape(args: tuple) -> List[int]:
    """The shape of the call's largest array (a BlockEll: its dense shape)."""
    arrays = [a for a in args if hasattr(a, "shape")]
    return [int(d) for d in max((a.shape for a in arrays), key=math.prod)]


def records_for(op, sizes: Optional[Sequence[int]] = None, *,
                hw: Optional[HardwareSpec] = None, device: str = "cuda",
                stream: bool = False, tuned=None) -> List[dict]:
    """One record per (engine, size, dtype) for a registered kernel.

    ``sizes`` overrides the reference's ``bench_sizes``; ``stream=True``
    sweeps the STREAM points instead.  ``device="cuda"`` launches the
    hand-written kernels; ``"cpu"`` runs their plain versions.  ``hw``
    (default: the card's spec, or the default advisor's on the CPU) is
    the hardware model the Advice, the predictions and the roofline
    gauge use.  ``tuned`` (a ``TuningCache``) supplies each engine's tile
    by (kernel, engine, dtype, ``hw.name``).
    """
    if device not in _COUNTS:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    hw = default_hw(device) if hw is None else hw
    dispatcher = Dispatcher(EngineAdvisor(hw), TuningPolicy(tuned))
    backend = "cuda" if device == "cuda" else "plain"
    warmup, iters = _COUNTS[device]
    clock = "cuda_event" if device == "cuda" else "wall"
    rng = np.random.default_rng(SEED)
    points = (stream_points(op, rng, device) if stream
              else sweep_points(op, rng, device, sizes))
    recs = []
    for pt in points:
        args, kw = pt.args, pt.kwargs
        advice = dispatcher.advise(op, *args, **kw)
        traits = op.traits(*args, **kw)
        want = op.reference(*args, **kw).float()
        ref = time_fn(lambda: op.reference(*args, **kw), warmup=warmup,
                      iters=iters, label="ref_call", layer="bench",
                      kernel=op.name, size=pt.size, dtype=pt.dtype)
        bound_bytes, _ = bound_work(op.name, args, traits)
        for engine in sorted(op.engines):
            # the correctness check and the timing both run the tile the
            # record reports (the tuned one, else the static default)
            got = dispatcher.run(op, *args, engine=engine, backend=backend,
                                 **kw)
            err = float((got.float() - want).abs().max())
            del got
            fn = op.engines[engine]
            tile = dispatcher.tile_params(op, engine, *args, **kw) or {}

            def call(fn=fn, tile=tile):
                return fn(*args, backend=backend, **{**kw, **tile})
            with capture() as view:
                t = time_fn(call, warmup=warmup, iters=iters,
                            label="engine_call", layer="bench",
                            kernel=op.name, engine=engine, size=pt.size,
                            dtype=pt.dtype)
            spans = [e for e in view.events if e.name == "engine_call"]
            us = round(t.median_us, 3)
            device_us = (round(device_busy_us(call, calls=iters), 3)
                         if device == "cuda" else None)
            recs.append({
                "kernel": op.name,
                "engine": engine,
                "size": pt.size,
                "dtype": pt.dtype,
                "shape": _shape(args),
                # the oracle's time, the reference's meaning of the field
                "ref_us_per_call": round(ref.median_us, 1),
                # the engine kernel's own median, spread and count
                "us_per_call": us,
                "iqr_us": round(t.iqr_us, 3),
                "iters": t.iters,
                "profiler_device_us": device_us,
                # the roofline gauge is derived from the *recorded*
                # (rounded) median so the trace_reconciliation claim
                # re-derives it exactly
                "trace": {
                    "clock": clock,
                    "spans": len(spans),
                    "span_median_us": round(statistics.median(
                        e.dur_us for e in spans), 3),
                    "roofline": roofline_sample(
                        traits, hw, engine, pt.dtype, us).as_attrs(),
                },
                "max_err": err,
                "intensity": traits.intensity,
                "memory_bound": advice.memory_bound,
                "engine_auto": advice.engine,
                "pred_us": round(traits.traffic_bytes / hw.mem_bw * 1e6, 3),
                "bound_bytes": bound_bytes,
                "l2_resident": bool(hw.l2_bytes is not None
                                    and bound_bytes <= hw.l2_bytes),
                "mxu_ceiling": advice.max_speedup_matrix,
                "tile_config": _tile_config_field(dispatcher, op, engine,
                                                  pt.dtype),
                "mesh_shape": None,
                "shard_spec": None,
                "mesh_exec": None,
            })
        # free this point's inputs before the generator builds the next
        del args, kw, want, pt
    return recs


def tracer_overhead(op, args: tuple, kw: dict, engine: str,
                    device: str = "cuda") -> dict:
    """The engine kernel's median without the tracer and captured, in
    turns (untraced, traced, traced, untraced), samples pooled per side.

    ``agree`` says whether the two medians lie within the larger IQR.
    """
    backend = "cuda" if device == "cuda" else "plain"
    warmup, iters = _COUNTS[device]
    fn = op.engines[engine]
    samples = {"untraced": [], "traced": []}
    for side in ("untraced", "traced", "traced", "untraced"):
        with (capture() if side == "traced" else contextlib.nullcontext()):
            t = time_fn(lambda: fn(*args, backend=backend, **kw),
                        warmup=warmup, iters=iters, label="engine_call",
                        layer="bench", kernel=op.name, engine=engine)
        samples[side].extend(t.samples_us)
    out = {}
    for side, xs in samples.items():
        q1, med, q3 = np.percentile(xs, (25, 50, 75))
        out[f"{side}_us"] = float(med)
        out[f"{side}_iqr_us"] = float(q3 - q1)
    out["agree"] = abs(out["traced_us"] - out["untraced_us"]) <= max(
        out["traced_iqr_us"], out["untraced_iqr_us"])
    return out


def rows(names: Optional[Sequence[str]] = None, json_dir: Optional[str] = None,
         *, trace_out: Optional[str] = None, stream: bool = False,
         device: str = "cuda", tuned: Optional[str] = None) -> List[dict]:
    """Sweep the registry; write ``BENCH_<kernel>.json`` per family.

    ``stream=True`` adds the STREAM points to each family's records.
    With *trace_out* the whole sweep runs under the tracer (dispatch and
    launch spans of the correctness calls, timing iterations) and the
    events are written as Chrome-trace JSON; the per-record captures
    nest inside that outer one.  *tuned* names a tuned.json whose tiles
    the sweep launches with (loaded forgivingly: a bad file warns and the
    static tiles run).
    """
    hw = default_hw(device)
    cache = None
    if tuned is not None:
        from ..tuning.cache import TuningCache
        cache = TuningCache.load_or_warn(tuned)
    wanted = set(names) if names is not None else None
    out = []
    with contextlib.ExitStack() as stack:
        sweep_view = (stack.enter_context(capture())
                      if trace_out is not None else None)
        for op in registry.all_ops():
            if wanted is not None and op.name not in wanted:
                continue
            recs = records_for(op, hw=hw, device=device, tuned=cache)
            if stream:
                recs += records_for(op, hw=hw, device=device, stream=True,
                                    tuned=cache)
            if json_dir:
                write_json(op.name, recs, json_dir,
                           env=bench_env(device, hw.name))
            out.extend(_csv_rows(recs, hw, device))
    if sweep_view is not None:
        write_chrome_trace(trace_out, sweep_view.events,
                           meta={"source": "repro_torch.bench.bench_kernels",
                                 "device": device, "hw_model": hw.name})
    return out


def _csv_rows(recs: List[dict], hw: HardwareSpec,
              device: str) -> List[dict]:
    """The stdout CSV projection of one kernel's sweep records.  The share
    of the byte bound is a card number: a CPU sweep prints none."""
    out = []
    for r in recs:
        share = (f"{r['bound_bytes'] / hw.mem_bw / (r['us_per_call'] * 1e-6):.4f}"
                 if device == "cuda" and r["us_per_call"] > 0
                 else "not measured")
        cfg = r.get("tile_config")
        tiles = "" if not cfg else ";tiles=" + ",".join(
            f"{k}={v}" for k, v in sorted(cfg["params"].items()))
        out.append({
            "name": (f"{r['kernel']}/{r['engine']}/n={r['size']}/"
                     f"{r['dtype']}"),
            "us_per_call": f"{r['us_per_call']:.3f}",
            "derived": (f"ref_us={r['ref_us_per_call']};"
                        f"pred_us={r['pred_us']};"
                        f"bound_share={share};"
                        f"l2_resident={r['l2_resident']};"
                        f"I={r['intensity']:.4f};"
                        f"auto={r['engine_auto']};"
                        f"mxu_ceiling={r['mxu_ceiling']:.4f}x;"
                        f"err={r['max_err']:.2e}" + tiles),
        })
    return out
