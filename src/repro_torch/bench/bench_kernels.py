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
  t = 3, flash-decode at B4 KH8 G4 Dh128, B4 KH4 G16 Dh128 and B4 KH8 G4
  Dh160, S = 32768, kv_len = 7S/8.

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

``mesh=N`` (``--mesh N``) sweeps the same points split N ways
(``repro_torch.sharding``), one shard after another on one device: the
dispatcher plans the shard spec onto its Advice, every engine runs
through the :class:`~repro_torch.sharding.ShardedExecutor`, ``max_err``
certifies the *sharded* result against the oracle, and each record
carries ``mesh_shape`` ``[N]`` and a ``shard_spec`` with the plan's
traffic accounting (per-shard bytes, aggregate vs. unsharded bytes, worst
per-shard intensity, ``pred_shard_us``), which the shard claims verify.
On a mesh record ``us_per_call`` is the median time of the whole sharded
call (every shard, its slicing and the reassembly), and ``shard_run``
holds the modelled clock's inputs: ``parallel_us`` / ``serial_us`` (the
medians of the slowest shard and of the sum, host wall time between
synchronizations, as the virtual clock charges them), each shard's median
wall ``shard_wall_us``, on the card each shard's time per call over 20
queued calls between one CUDA-event pair, ``shard_event_us`` (the card's
time where the calls queue, :func:`~repro_torch.core.timing.queued_event_us`),
and ``equal_unsharded``, whether the combined output equals the
unsharded call's bit for bit.

``real=True`` (``--real``, with ``mesh = N >= 2``) also runs every point
on N ranks at once (:class:`~repro_torch.sharding.executor.MeshExecutor`):
one measured mesh execution per point, shared by its engine records, as
the reference shares it; the ranks launch the engine the dispatcher picks
under ``auto``.  Each record then carries the schema-6 ``mesh_exec``
(``mesh_wall_us``, ``collective_us``, ``virtual_us``, ``skew`` and
``mesh_max_err``, the mesh output against the oracle) and its trace
block a ``mesh`` entry (the ``mesh_step`` spans), and :func:`rows`
writes the overlap probe into each file's ``env.collective_overlap``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import statistics
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..carry import cast
from ..core.advisor import EngineAdvisor
from ..core.dispatch import DEFAULT_DISPATCHER, Dispatcher, TuningPolicy
from ..core.hw import HardwareSpec, spec_for_device_name
from ..core.timing import device_busy_us, queued_event_us
from ..kernels import registry
from ..obs.counters import roofline_sample
from ..obs.trace import capture, write_chrome_trace
from ..sharding import MeshExecutor, ShardedExecutor, shard_call, traffic
from .common import bench_env, time_fn, write_json

__all__ = ["SEED", "Point", "bound_work", "default_hw", "mesh_exec_field",
           "records_for", "rows", "stream_points", "sweep_points",
           "tracer_overhead"]

SEED = 0
#: (warmup, timed) calls per measurement: on the card the CUDA-event
#: median of 20 calls; on the CPU the reference's time_fn defaults.
_COUNTS = {"cuda": (3, 20), "cpu": (2, 5)}
#: Flash-decode's STREAM shapes: Mistral-NeMo-12B's decode heads (G = 32 /
#: 8 query heads per KV head, Dh = 128), Qwen3-MoE-235B-A22B's (G = 64 / 4
#: = 16, the kernels' widest head tile) and StableLM-2-12B's (G 4 at Dh
#: 5120 / 32 = 160), over a long cache.  All record as size S and differ
#: in ``shape``, which ends a port record's ``BenchRecord.point``, so the
#: compare gate keeps them apart.
_ATTN_STREAM = ({"b": 4, "kh": 8, "g": 4, "dh": 128, "s": 32768},
                {"b": 4, "kh": 4, "g": 16, "dh": 128, "s": 32768},
                {"b": 4, "kh": 8, "g": 4, "dh": 160, "s": 32768})


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
        for p in _ATTN_STREAM:
            for dtype in ("float32", "bfloat16"):
                q = _normal(rng, (p["b"], p["kh"], p["g"], p["dh"]), dtype,
                            device)
                k, v = (_normal(rng, (p["b"], p["s"], p["kh"], p["dh"]),
                                dtype, device) for _ in range(2))
                yield Point(p["s"], dtype, (q, k, v, p["s"] - p["s"] // 8),
                            {})
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


def _shard_spec_field(op, plan, args, kw, hw: HardwareSpec) -> dict:
    """The schema-5 ``shard_spec`` evidence for one mesh sweep point: the
    plan's compact spec plus its Eq. 2 traffic accounting and the
    per-shard memory floor on the record's hardware model."""
    t = traffic(op, plan, args, kw)
    return {
        **plan.spec.to_json(),
        "total_bytes": t["total_bytes"],
        "agg_bytes": t["agg_bytes"],
        "wire_bytes": t["wire_bytes"],
        "shard_bytes": t["shard_bytes"],
        "shard_intensity": t["shard_intensity"],
        "pred_shard_us": round(t["shard_bytes"] / hw.mem_bw * 1e6, 3),
    }


def _median(xs: Sequence[float]) -> float:
    return float(statistics.median(xs))


def _shape(args: tuple) -> List[int]:
    """The shape of the call's largest array (a BlockEll: its dense shape)."""
    arrays = [a for a in args if hasattr(a, "shape")]
    return [int(d) for d in max((a.shape for a in arrays), key=math.prod)]


def mesh_exec_field(mex: MeshExecutor, op, plan, args: tuple, kw: dict,
                    want: torch.Tensor, warmup: int = 2, iters: int = 5
                    ) -> Tuple[dict, dict, torch.Tensor]:
    """(``mesh_exec``, the trace block's ``mesh`` entry, the mesh output)
    of one point: one mesh step whose output is held against the oracle
    *want* (``mesh_max_err``), then :meth:`MeshExecutor.measure` with its
    ``mesh_step`` spans captured."""
    out = mex.run(op, *args, plan=plan, **kw).out
    err = float((out.float() - want).abs().max())
    with capture() as view:
        field = mex.measure(op, *args, plan=plan, warmup=warmup,
                            iters=iters, **kw)
    field["mesh_max_err"] = err
    steps = [e for e in view.events if e.name == "mesh_step"]
    trace = {"spans": len(steps),
             "span_median_us": round(statistics.median(
                 e.dur_us for e in steps), 3),
             "mesh_wall_us": field["mesh_wall_us"]}
    return field, trace, out


def records_for(op, sizes: Optional[Sequence[int]] = None, *,
                hw: Optional[HardwareSpec] = None, device: str = "cuda",
                stream: bool = False, tuned=None, mesh: int = 1,
                real: bool = False,
                check_widths: Sequence[int] = ()) -> List[dict]:
    """One record per (engine, size, dtype) for a registered kernel.

    ``sizes`` overrides the reference's ``bench_sizes``; ``stream=True``
    sweeps the STREAM points instead.  ``device="cuda"`` launches the
    hand-written kernels; ``"cpu"`` runs their plain versions.  ``hw``
    (default: the card's spec, or the default advisor's on the CPU) is
    the hardware model the Advice, the predictions and the roofline
    gauge use.  ``tuned`` (a ``TuningCache``) supplies each engine's tile
    by (kernel, engine, dtype, ``hw.name``).  ``mesh > 1`` splits every
    point ``mesh`` ways (module docstring); each width of
    ``check_widths`` also runs the point split that many ways, untimed, and
    ``shard_run["equal_unsharded_at"]`` records whether it equals the
    unsharded output bit for bit.  ``real`` adds the measured mesh
    (module docstring).
    """
    if device not in _COUNTS:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    hw = default_hw(device) if hw is None else hw
    dispatcher = Dispatcher(EngineAdvisor(hw), TuningPolicy(tuned),
                            mesh_shards=mesh,
                            mesh_mode="mesh" if real else "virtual")
    backend = "cuda" if device == "cuda" else "plain"
    sharded = (ShardedExecutor(mesh, backend=backend, dispatcher=dispatcher)
               if mesh > 1 else None)
    mex = (MeshExecutor(mesh, backend=backend, dispatcher=dispatcher)
           if real and mesh > 1 else None)
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
        plan = sharded.plan(op, *args, **kw) if sharded else None
        # engine-invariant: the split and its byte accounting depend only
        # on the call shape
        shard_field = (_shard_spec_field(op, plan, args, kw, hw)
                       if plan is not None else None)
        mesh_field = mesh_trace = None
        if mex is not None:
            mesh_field, mesh_trace, _ = mesh_exec_field(
                mex, op, plan, args, kw, want, warmup, iters)
        for engine in sorted(op.engines):
            # the correctness check and the timing both run the tile the
            # record reports (the tuned one, else the static default)
            got = dispatcher.run(op, *args, engine=engine, backend=backend,
                                 **kw)
            fn = op.engines[engine]
            tile = dispatcher.tile_params(op, engine, *args, **kw) or {}
            shard_run = None
            if sharded is None:
                def call(fn=fn, tile=tile):
                    return fn(*args, backend=backend, **{**kw, **tile})
            else:
                runs = []

                def call(engine=engine, tile=tile, runs=runs):
                    run = sharded.run(op, *args, engine=engine, plan=plan,
                                      **{**kw, **tile})
                    runs.append(run.shard_seconds)
                    return run.out
                full, got = got, call()
                shard_run = {"equal_unsharded": bool(torch.equal(got,
                                                                 full))}
                for width in check_widths:
                    other = ShardedExecutor(
                        width, backend=backend, dispatcher=dispatcher).run(
                            op, *args, engine=engine, **{**kw, **tile}).out
                    shard_run.setdefault("equal_unsharded_at", {})[
                        str(width)] = bool(torch.equal(other, full))
                    del other
                del full
            err = float((got.float() - want).abs().max())
            del got
            with capture() as view:
                t = time_fn(call, warmup=warmup, iters=iters,
                            label="engine_call", layer="bench",
                            kernel=op.name, engine=engine, size=pt.size,
                            dtype=pt.dtype)
            spans = [e for e in view.events if e.name == "engine_call"]
            us = round(t.median_us, 3)
            device_us = (round(device_busy_us(call, calls=iters), 3)
                         if device == "cuda" else None)
            if shard_run is not None:
                # the time_fn iterations: after the correctness call and
                # the warm-up calls
                timed = runs[1 + warmup:1 + warmup + iters]
                shard_run.update(_shard_times(op, plan, args, kw, fn,
                                              tile, timed, backend))
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
                    **({"mesh": mesh_trace} if mesh_trace is not None
                       else {}),
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
                "mesh_shape": [mesh] if mesh > 1 else None,
                "shard_spec": shard_field,
                "shard_run": shard_run,
                "mesh_exec": mesh_field,
            })
        # free this point's inputs before the generator builds the next
        del args, kw, want, pt
    return recs


def _shard_times(op, plan, args: tuple, kw: dict, fn, tile: dict,
                 runs: Sequence[Tuple[float, ...]], backend: str) -> dict:
    """``shard_run``'s times from the timed iterations' per-shard walls,
    plus each shard's profiler device time on the card."""
    out = {
        "parallel_us": round(_median([max(r) for r in runs]) * 1e6, 3),
        "serial_us": round(_median([sum(r) for r in runs]) * 1e6, 3),
        "shard_wall_us": [round(_median(col) * 1e6, 3)
                          for col in zip(*runs)],
        "shard_event_us": None,
    }
    if backend == "cuda":
        event_us = []
        for shard in plan.shards:
            sargs, skw = shard_call(plan, shard, args, kw)
            event_us.append(round(queued_event_us(functools.partial(
                fn, *sargs, backend=backend, **{**skw, **tile})), 3))
            del sargs, skw
        out["shard_event_us"] = event_us
    return out


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
         device: str = "cuda", tuned: Optional[str] = None,
         mesh: int = 1, real: bool = False) -> List[dict]:
    """Sweep the registry; write ``BENCH_<kernel>.json`` per family
    (``BENCH_<kernel>_mesh<N>.json`` for ``mesh = N > 1``).

    ``stream=True`` adds the STREAM points to each family's records.
    With *trace_out* the whole sweep runs under the tracer (dispatch and
    launch spans of the correctness calls, timing iterations) and the
    events are written as Chrome-trace JSON; the per-record captures
    nest inside that outer one.  *tuned* names a tuned.json whose tiles
    the sweep launches with (loaded forgivingly: a bad file warns and the
    static tiles run).  ``real`` measures every point on ``mesh`` ranks
    too, and runs the overlap probe once for every file's env.
    """
    hw = default_hw(device)
    overlap = (MeshExecutor(mesh, backend="cuda" if device == "cuda"
                            else "plain").overlap_probe()
               if real and mesh > 1 else None)
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
            recs = records_for(op, hw=hw, device=device, tuned=cache,
                               mesh=mesh, real=real)
            if stream:
                recs += records_for(op, hw=hw, device=device, stream=True,
                                    tuned=cache, mesh=mesh, real=real)
            if json_dir:
                env = bench_env(device, hw.name)
                if mesh > 1:
                    env["mesh_shape"] = [mesh]
                    env["mesh_exec_mode"] = "mesh" if real else "virtual"
                if overlap is not None:
                    env["collective_overlap"] = overlap
                write_json(op.name, recs, json_dir, env=env, mesh=mesh)
            out.extend(_csv_rows(recs, hw, device))
    if sweep_view is not None:
        write_chrome_trace(trace_out, sweep_view.events,
                           meta={"source": "repro_torch.bench.bench_kernels",
                                 "device": device, "hw_model": hw.name,
                                 "mesh": mesh, "real": bool(real)})
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
        spec = r.get("shard_spec")
        name = f"{r['kernel']}/{r['engine']}/n={r['size']}/{r['dtype']}"
        if spec:
            run = r["shard_run"]
            name += f"/mesh={r['mesh_shape'][0]}"
            tiles += (f";shards={spec['num_shards']};halo={spec['halo']};"
                      f"agg/total={spec['agg_bytes'] / spec['total_bytes']:.3f};"
                      f"parallel_us={run['parallel_us']};"
                      f"serial_us={run['serial_us']};"
                      f"equal_unsharded={run['equal_unsharded']}")
            mex = r.get("mesh_exec")
            if mex:
                tiles += (f";mesh_wall_us={mex['mesh_wall_us']};"
                          f"coll_us={mex['collective_us']};"
                          f"skew={mex['skew']}")
        out.append({
            "name": name,
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
