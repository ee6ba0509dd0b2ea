"""Benchmark record ingestion for the claims layer (paper §5 evidence).

Loads ``BENCH_*.json`` record files into typed rows, with the reference
package's schemas and validation:

* schema 1 (legacy) -- a bare JSON list of record dicts,
* schemas 2-7 -- ``{"schema": N, "kernel": ..., "env": {...},
  "records": [...]}``; schema 3 adds ``tile_config``, schema 5 the mesh
  fields ``mesh_shape`` / ``shard_spec``, schema 6 ``mesh_exec``, and
  schema 7 the obs ``trace`` block,
* serving sets (``"kind": "serving"``; plain schema 4 defaults to it):
  one :class:`ServingRecord` per session.

The port's sweep (``repro_torch.bench``) writes schema-7 bench sets and
adds optional per-record fields for what the card measures:
``us_per_call`` (the engine kernel's own CUDA-event median),
``profiler_device_us`` (torch.profiler's device time per call),
``bound_bytes`` (the bytes the function must move on these inputs) and
``l2_resident`` (the point's bytes fit in the card's L2, so its shares
are not HBM shares) and ``shape`` (the call's largest array, part of
:attr:`BenchRecord.point`).  The reference's TPU-named ``pred_us_v5e`` is read
into the neutral :attr:`BenchRecord.pred_us`, which the port writes
under that name; a reference file loads unchanged.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
from typing import Any, Mapping, Optional, Tuple, Union

__all__ = ["BenchRecord", "RecordSet", "ServingRecord", "load_dir",
           "load_file"]

_REQUIRED = ("kernel", "engine", "size", "dtype", "ref_us_per_call",
             "max_err", "intensity", "memory_bound", "engine_auto",
             "mxu_ceiling")


@dataclasses.dataclass(frozen=True)
class BenchRecord:
    """One benchmark sweep point: measurement + analytic join fields.

    Mirrors the per-record dict written by ``repro_torch.bench.bench_kernels``
    (and by the reference's ``benchmarks.bench_kernels``):
    ``intensity`` is Eq. 2's I = W/Q, ``memory_bound`` is the Eq. 4 test
    against the vector-engine machine balance, and ``mxu_ceiling`` is the
    advisor's tightest matrix-engine speedup bound (Eq. 17/23/24).
    """

    kernel: str
    engine: str               # which engine variant was checked
    size: int
    dtype: str
    ref_us_per_call: float    # median oracle time
    max_err: float            # |engine variant - oracle| max abs error
    intensity: float          # Eq. 2: I = W / Q
    memory_bound: bool        # Eq. 4: I < B_vector
    engine_auto: str          # what engine='auto' resolved to
    mxu_ceiling: float        # advisor's matrix-engine speedup ceiling
    # Q / mem_bw analytic floor on the record's hardware model (read from
    # the reference's ``pred_us_v5e`` or the port's ``pred_us``)
    pred_us: Optional[float] = None
    iqr_us: Optional[float] = None       # timing spread (schema 2)
    iters: Optional[int] = None          # timing iterations (schema 2)
    # schema 3: tuned tile params + tuner timings ({"params": {...},
    # "tuned_us": ..., "default_us": ..., "source": ...}); None means
    # the launch used the family's static tile defaults
    tile_config: Optional[Mapping[str, Any]] = None
    # schema 5: the mesh the point was swept under ([N]) and the shard
    # plan + traffic accounting it executed with; None = single device
    mesh_shape: Optional[Tuple[int, ...]] = None
    shard_spec: Optional[Mapping[str, Any]] = None
    # schema 6: measured real-mesh execution evidence ({"mode": "mesh",
    # "devices": N, "mesh_wall_us", "collective_us", "virtual_us",
    # "skew", "mesh_max_err", ...}); None = no real-mesh run
    mesh_exec: Optional[Mapping[str, Any]] = None
    # schema 7: the obs tracer's reconciliation block ({"clock":
    # "wall", "spans", "span_median_us", roofline counters, optional
    # "mesh" sub-block}); None = swept without tracing
    trace: Optional[Mapping[str, Any]] = None
    # port fields: the engine kernel's own median (us; the reference's
    # records time only the oracle), torch.profiler's device time per
    # call, the bytes the function must move on these inputs, and whether
    # those bytes fit in the card's L2
    us_per_call: Optional[float] = None
    profiler_device_us: Optional[float] = None
    bound_bytes: Optional[float] = None
    l2_resident: Optional[bool] = None
    # the shape of the call's largest array (a BlockEll: its dense shape)
    shape: Optional[Tuple[int, ...]] = None

    @property
    def timed_us(self) -> float:
        """The recorded median the trace reconciles against: the engine
        kernel's ``us_per_call`` where recorded, else the oracle's."""
        return (self.us_per_call if self.us_per_call is not None
                else self.ref_us_per_call)

    def bound_share(self, mem_bw: float) -> Optional[float]:
        """``bound_bytes / mem_bw`` over ``us_per_call``: the share of the
        byte bound the engine kernel reached (an HBM share only where the
        point is not ``l2_resident``); None without both fields."""
        if self.bound_bytes is None or not self.us_per_call:
            return None
        return self.bound_bytes / mem_bw / (self.us_per_call * 1e-6)

    @property
    def num_shards(self) -> int:
        """Shards the point executed across (1 = unsharded sweep)."""
        if not self.shard_spec:
            return 1
        return int(self.shard_spec.get("num_shards", 1))

    @property
    def mesh_devices(self) -> int:
        """Devices the recorded mesh requested (1 = no mesh)."""
        if not self.mesh_shape:
            return 1
        n = 1
        for d in self.mesh_shape:
            n *= int(d)
        return n

    @property
    def point(self) -> Tuple:
        """The sweep-point key (kernel, engine, size, dtype, mesh[, shape]).

        The *requested* mesh width (``mesh_devices``) is part of the
        key so the compare gate joins a 2-way-mesh point against the
        2-way baseline — never against the single-device sweep — and a
        lost mesh width is reported as missing coverage (a shard-count
        regression), not silently merged.  Keyed on the request, not
        the effective ``num_shards``: a clamped sweep (e.g. attention
        4-way over 2 KV heads plans 2 shards) must still join its own
        mesh-4 baseline rather than collide with a genuine 2-way sweep.

        A port record's ``shape`` ends the key as ``"4x32768x8x128"``:
        the two flash-decode STREAM points share the cache length S (their
        ``size``) and differ in their heads, so without it one would
        overwrite the other in the gate's index and a baseline's point
        would be held against the other's.  The reference's records carry
        no shape and keep the five-field key.
        """
        key = (self.kernel, self.engine, self.size, self.dtype,
               self.mesh_devices)
        if self.shape is None:
            return key
        return key + ("x".join(map(str, self.shape)),)

    @property
    def tile_params(self) -> Optional[Mapping[str, int]]:
        """The tuned tile params this point launched with, if any."""
        if not self.tile_config:
            return None
        return self.tile_config.get("params")

    @property
    def tuned_speedup(self) -> Optional[float]:
        """Tuner-measured default_us / tuned_us for this point's config."""
        if not self.tile_config:
            return None
        tuned = self.tile_config.get("tuned_us")
        default = self.tile_config.get("default_us")
        if not tuned or not default or tuned <= 0:
            return None
        return float(default) / float(tuned)


_SERVING_REQUIRED = (
    "kernel", "engine", "engine_auto", "workload", "rate_rps",
    "duration_s", "size", "dtype", "seed", "offered", "completed",
    "p50_ms", "p95_ms", "p99_ms", "queue_p50_ms", "compute_p50_ms",
    "goodput_rps", "slo_ms", "slo_attainment", "intensity",
    "memory_bound", "mxu_ceiling")


@dataclasses.dataclass(frozen=True)
class ServingRecord:
    """One serving session: load model + latency/goodput + analytics.

    Mirrors the dict built by the reference's
    ``repro.serving.metrics.serving_record``:
    the workload model and offered rate, latency percentiles in
    milliseconds (end-to-end plus the queue/compute split at the
    batch-launch boundary), goodput/SLO accounting per
    its ``serving.slo``, and the analytic join fields (Eq. 2
    intensity, Eq. 4 boundedness, the Eq. 17/23/24 ceiling, §6
    auto-routing) the claims layer re-derives under load.
    """

    kernel: str
    engine: str               # session engine ('vector'|'matrix'|'mixed')
    engine_auto: str          # what the memoized Advice resolved to
    workload: str             # 'poisson' | 'bursty' | 'closed' | 'trace'
    rate_rps: float           # offered rate knob of the generator
    duration_s: float         # session horizon (virtual seconds)
    size: int                 # per-request elements / decode tokens
    dtype: str
    seed: int                 # loadgen seed (sessions are replayable)
    offered: int              # arrivals inside the horizon
    completed: int            # requests served
    p50_ms: float             # end-to-end latency percentiles
    p95_ms: float
    p99_ms: float
    queue_p50_ms: float       # batch-formation wait split
    compute_p50_ms: float     # shared batch compute split
    goodput_rps: float        # SLO-attaining completions per second
    slo_ms: float             # the session's latency objective
    slo_attainment: float     # attained fraction of completions
    intensity: float          # Eq. 2: I = W / Q
    memory_bound: bool        # Eq. 4: I < B_vector
    mxu_ceiling: float        # advisor's matrix-engine speedup ceiling
    queue_p99_ms: Optional[float] = None
    compute_p99_ms: Optional[float] = None
    throughput_rps: Optional[float] = None
    batches: Optional[int] = None
    mean_batch: Optional[float] = None
    # batching-policy knobs the session ran under: part of the
    # comparability contract the compare gate enforces on joined keys
    max_batch: Optional[int] = None
    max_wait_ms: Optional[float] = None
    # mesh width the session's batches were sharded across (each batch
    # charged shard-parallel compute); None/1 = unsharded.  Also part
    # of the comparability contract: p99 under a 2-way mesh must never
    # gate against a single-device baseline.
    num_shards: Optional[int] = None
    # how sharded batches were charged: "virtual" (modeled
    # max-over-shards clock) or "mesh" (measured shard_map wall time
    # on real devices); None = unsharded/legacy.  Part of the
    # comparability contract too: measured p99 never gates against a
    # modeled one.
    mesh_exec_mode: Optional[str] = None
    # lm sessions only: the full-size architecture the session speaks
    # for, the measured prefill/decode phase split, and the per-op
    # model-scale verdict ({"ops": [...], "memory_bound_time_frac",
    # ...}) the model_verdict claim re-derives; all None for kernel
    # sessions
    model: Optional[str] = None
    phases: Optional[Mapping[str, Any]] = None
    verdict: Optional[Mapping[str, Any]] = None
    # chaos sessions only (ElasticSession): the failure/resize event
    # block ({"spec", "availability", "checksum", "fault_free": {...},
    # "log": [...]}) the elastic_integrity claim re-verifies; None for
    # ordinary sessions
    events: Optional[Mapping[str, Any]] = None
    # serving schema 5: the obs tracer's reconciliation block
    # ({"clock": "virtual", "batch_spans", "span_compute_ms",
    # "log_compute_ms", chaos instant counts}); None = legacy session
    trace: Optional[Mapping[str, Any]] = None
    # online-tuned sessions only: the bandit + router block ({"mode":
    # "online", "budget", "keys": {key: {arms, events, ...}}, optional
    # "router"}) whose decisions the online_ceiling claim replays
    # against Eq. 23/24; None for statically-tuned sessions
    tuning: Optional[Mapping[str, Any]] = None

    @property
    def tuning_mode(self) -> str:
        """'online' when the session carried a tuning block, else
        'static' — part of the session key so an adaptively-tuned p99
        never gates against a statically-tuned baseline."""
        if not self.tuning:
            return "static"
        return str(self.tuning.get("mode", "online"))

    @property
    def point(self) -> Tuple[str, str, str, int, str, int, str]:
        """Session key (kernel, engine, workload, size, dtype, shards,
        tuning mode) — what the ``benchmarks/compare.py`` p99/goodput
        gate joins on.

        The mesh width is part of the key (legacy records without one
        key as 1) so a sharded session never gates against — or
        silently shadows — the single-device baseline when both live
        in one records directory; the tuning mode (``'static'`` /
        ``'online'``) separates adaptively-tuned sessions from their
        static baselines the same way.
        """
        return (self.kernel, self.engine, self.workload, self.size,
                self.dtype, self.num_shards or 1, self.tuning_mode)


@dataclasses.dataclass(frozen=True)
class RecordSet:
    """All records of one ``BENCH_*.json`` file plus metadata.

    ``kind`` says what the records are: ``'bench'`` sweep points
    (schemas 1-3) or ``'serving'`` session records (schema 4).
    """

    kernel: str
    schema: int
    env: Mapping[str, Any]
    records: Tuple[Union[BenchRecord, ServingRecord], ...]
    path: str
    kind: str = "bench"

    @property
    def mesh_devices(self) -> int:
        """Devices of the mesh this set was swept under (1 = no mesh).

        Schema-5 mesh sweeps stamp ``mesh_shape`` into their
        environment metadata; everything earlier is single-device.
        """
        shape = self.env.get("mesh_shape")
        if not shape:
            return 1
        n = 1
        for d in shape:
            n *= int(d)
        return n


def _to_record(raw: Mapping[str, Any], path: str) -> BenchRecord:
    missing = [k for k in _REQUIRED if k not in raw]
    if missing:
        raise ValueError(f"{path}: record missing fields {missing}; "
                         f"got {sorted(raw)}")
    tile_config = raw.get("tile_config")
    if tile_config is not None:
        if not isinstance(tile_config, Mapping) or \
                not isinstance(tile_config.get("params"), Mapping):
            raise ValueError(f"{path}: tile_config must be an object "
                             f"with a 'params' map, got {tile_config!r}")
        tile_config = dict(tile_config)
    mesh_shape = raw.get("mesh_shape")
    if mesh_shape is not None:
        if not isinstance(mesh_shape, (list, tuple)) or not mesh_shape:
            raise ValueError(f"{path}: mesh_shape must be a non-empty "
                             f"list, got {mesh_shape!r}")
        mesh_shape = tuple(int(d) for d in mesh_shape)
    shard_spec = raw.get("shard_spec")
    if shard_spec is not None:
        if not isinstance(shard_spec, Mapping) or \
                "num_shards" not in shard_spec:
            raise ValueError(f"{path}: shard_spec must be an object "
                             f"with a 'num_shards' field, got "
                             f"{shard_spec!r}")
        shard_spec = dict(shard_spec)
    mesh_exec = raw.get("mesh_exec")
    if mesh_exec is not None:
        needed = ("devices", "mesh_wall_us", "collective_us",
                  "virtual_us")
        if not isinstance(mesh_exec, Mapping) or \
                any(k not in mesh_exec for k in needed):
            raise ValueError(f"{path}: mesh_exec must be an object "
                             f"with {needed} fields, got {mesh_exec!r}")
        mesh_exec = dict(mesh_exec)
    trace = _check_trace(raw.get("trace"), path)
    return BenchRecord(
        kernel=str(raw["kernel"]),
        engine=str(raw["engine"]),
        size=int(raw["size"]),
        dtype=str(raw["dtype"]),
        ref_us_per_call=float(raw["ref_us_per_call"]),
        max_err=float(raw["max_err"]),
        intensity=float(raw["intensity"]),
        memory_bound=bool(raw["memory_bound"]),
        engine_auto=str(raw["engine_auto"]),
        mxu_ceiling=float(raw["mxu_ceiling"]),
        pred_us=_opt_float(raw.get("pred_us", raw.get("pred_us_v5e"))),
        iqr_us=(float(raw["iqr_us"])
                if raw.get("iqr_us") is not None else None),
        iters=(int(raw["iters"])
               if raw.get("iters") is not None else None),
        tile_config=tile_config,
        mesh_shape=mesh_shape,
        shard_spec=shard_spec,
        mesh_exec=mesh_exec,
        trace=trace,
        us_per_call=_opt_float(raw.get("us_per_call")),
        profiler_device_us=_opt_float(raw.get("profiler_device_us")),
        bound_bytes=_opt_float(raw.get("bound_bytes")),
        l2_resident=(bool(raw["l2_resident"])
                     if raw.get("l2_resident") is not None else None),
        shape=(tuple(int(d) for d in raw["shape"])
               if raw.get("shape") is not None else None),
    )


def _opt_float(v: Any) -> Optional[float]:
    return float(v) if v is not None else None


def _check_trace(trace: Any, path: str) -> Optional[dict]:
    """Validate a record's optional ``trace`` reconciliation block."""
    if trace is None:
        return None
    if not isinstance(trace, Mapping) or "clock" not in trace:
        raise ValueError(f"{path}: trace must be an object with a "
                         f"'clock' field, got {trace!r}")
    return dict(trace)


def _to_serving_record(raw: Mapping[str, Any], path: str) -> ServingRecord:
    missing = [k for k in _SERVING_REQUIRED if k not in raw]
    if missing:
        raise ValueError(f"{path}: serving record missing fields "
                         f"{missing}; got {sorted(raw)}")
    opt = {k: raw.get(k) for k in ("queue_p99_ms", "compute_p99_ms",
                                   "throughput_rps", "mean_batch",
                                   "max_wait_ms")}
    phases = raw.get("phases")
    if phases is not None and not isinstance(phases, Mapping):
        raise ValueError(f"{path}: phases must be an object, "
                         f"got {phases!r}")
    verdict = raw.get("verdict")
    if verdict is not None:
        if not isinstance(verdict, Mapping) or \
                not isinstance(verdict.get("ops"), list):
            raise ValueError(f"{path}: verdict must be an object with "
                             f"an 'ops' list, got {verdict!r}")
        verdict = dict(verdict)
    events = raw.get("events")
    if events is not None:
        if not isinstance(events, Mapping) or \
                not isinstance(events.get("log"), list):
            raise ValueError(f"{path}: events must be an object with "
                             f"a 'log' list, got {events!r}")
        events = dict(events)
    tuning = raw.get("tuning")
    if tuning is not None:
        needed = ("mode", "budget", "keys")
        if not isinstance(tuning, Mapping) or \
                any(k not in tuning for k in needed) or \
                not isinstance(tuning.get("keys"), Mapping):
            raise ValueError(f"{path}: tuning must be an object with "
                             f"{needed} fields (keys a map), got "
                             f"{tuning!r}")
        tuning = dict(tuning)
    trace = _check_trace(raw.get("trace"), path)
    return ServingRecord(
        kernel=str(raw["kernel"]),
        engine=str(raw["engine"]),
        engine_auto=str(raw["engine_auto"]),
        workload=str(raw["workload"]),
        rate_rps=float(raw["rate_rps"]),
        duration_s=float(raw["duration_s"]),
        size=int(raw["size"]),
        dtype=str(raw["dtype"]),
        seed=int(raw["seed"]),
        offered=int(raw["offered"]),
        completed=int(raw["completed"]),
        p50_ms=float(raw["p50_ms"]),
        p95_ms=float(raw["p95_ms"]),
        p99_ms=float(raw["p99_ms"]),
        queue_p50_ms=float(raw["queue_p50_ms"]),
        compute_p50_ms=float(raw["compute_p50_ms"]),
        goodput_rps=float(raw["goodput_rps"]),
        slo_ms=float(raw["slo_ms"]),
        slo_attainment=float(raw["slo_attainment"]),
        intensity=float(raw["intensity"]),
        memory_bound=bool(raw["memory_bound"]),
        mxu_ceiling=float(raw["mxu_ceiling"]),
        batches=(int(raw["batches"])
                 if raw.get("batches") is not None else None),
        max_batch=(int(raw["max_batch"])
                   if raw.get("max_batch") is not None else None),
        num_shards=(int(raw["num_shards"])
                    if raw.get("num_shards") is not None else None),
        mesh_exec_mode=(str(raw["mesh_exec_mode"])
                        if raw.get("mesh_exec_mode") is not None
                        else None),
        model=(str(raw["model"])
               if raw.get("model") is not None else None),
        phases=(dict(phases) if phases is not None else None),
        verdict=verdict,
        events=events,
        tuning=tuning,
        trace=trace,
        **{k: (float(v) if v is not None else None)
           for k, v in opt.items()},
    )


def load_file(path: str) -> RecordSet:
    """Parse one BENCH_*.json (schema 1-7) into a RecordSet.

    Payloads with ``"kind": "serving"`` (every serving schema; plain
    schema-4 payloads default to it) load as :class:`ServingRecord`
    rows; everything else as :class:`BenchRecord` sweep points.
    Raises ``ValueError`` on unknown schema versions or records
    missing the fields the claim checks (Eq. 23/24 ceiling, §6
    routing) need.
    """
    with open(path) as f:
        payload = json.load(f)
    kind = "bench"
    if isinstance(payload, list):          # schema 1: bare record list
        schema, env, raw_records = 1, {}, payload
    elif isinstance(payload, dict):
        schema = int(payload.get("schema", 0))
        if schema not in (2, 3, 4, 5, 6, 7):
            raise ValueError(f"{path}: unsupported schema {schema!r} "
                             f"(expected 1-list, or 2-7)")
        # schema 4 was serving-only, so a missing kind means serving
        # there; later schemas carry the kind explicitly (bench and
        # serving version numbers advance independently)
        kind = str(payload.get("kind",
                               "serving" if schema == 4 else "bench"))
        if kind not in ("bench", "serving"):
            raise ValueError(f"{path}: unknown kind {kind!r} "
                             f"(expected 'bench' or 'serving')")
        env = dict(payload.get("env", {}))
        raw_records = payload.get("records")
        if not isinstance(raw_records, list):
            raise ValueError(f"{path}: schema-{schema} payload missing "
                             f"its 'records' list")
    else:
        raise ValueError(f"{path}: expected a list or object, "
                         f"got {type(payload).__name__}")
    to_record = _to_serving_record if kind == "serving" else _to_record
    records = tuple(to_record(r, path) for r in raw_records)
    if not records:
        raise ValueError(f"{path}: no records")
    kernels = sorted({r.kernel for r in records})
    if len(kernels) != 1:
        raise ValueError(f"{path}: mixed kernels {kernels} in one file")
    return RecordSet(kernel=kernels[0], schema=schema, env=env,
                     records=records, path=path, kind=kind)


def load_dir(runs_dir: str = "runs") -> Tuple[RecordSet, ...]:
    """Load every ``BENCH_*.json`` under *runs_dir*, sorted by
    (kernel, kind, mesh) — a family's single-device bench sweep sorts
    before its mesh sweeps, which sort before its serving sessions.

    Ingestion is explicit about what it skips: ``TRACE_*.json``
    companions (Chrome-trace exports living next to their records) are
    silently ignored, and any *other* stray file in the record
    directory gets a structured warning (``repro_torch.obs.log``) instead of
    being invisibly passed over by glob luck.

    This is the measurement half of the paper's measure-vs-theory loop;
    the returned sets feed ``repro_torch.report.claims.check_records``.
    """
    from ..obs.log import LOG
    paths = []
    for name in sorted(os.listdir(runs_dir)):
        full = os.path.join(runs_dir, name)
        if not os.path.isfile(full):
            continue
        if fnmatch.fnmatch(name, "BENCH_*.json"):
            paths.append(full)
        elif fnmatch.fnmatch(name, "TRACE_*.json"):
            continue  # trace artifacts ride along with their records
        else:
            LOG.warning("skipping non-record file in record directory",
                        dir=runs_dir, file=name)
    if not paths:
        raise FileNotFoundError(f"no BENCH_*.json files under {runs_dir!r}")
    sets = tuple(sorted((load_file(p) for p in paths),
                        key=lambda s: (s.kernel, s.kind,
                                       s.mesh_devices)))
    return sets
