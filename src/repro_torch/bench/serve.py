"""Serving benchmark: latency-percentile sessions over the dispatcher.

``python -m repro_torch.bench serve`` drives the request-level serving
subsystem (``repro_torch.serving``) against registered kernel families:
one session per (kernel, engine, workload), each replaying the same
seeded traffic through the continuous-batching scheduler with the engine
forced to the vector and then the matrix variant (plus whatever
``engine='auto'`` resolves to via the memoized Advice, recorded so the
claims layer can re-check §6 routing under load).

Each kernel's sessions land in ``<out>/BENCH_serve_<kernel>.json``
(serving schema 5, default ``build/runs_torch``) for the claims layer
and the ``repro_torch.bench.compare --kind serving`` p99/goodput gate; a
summary row prints per session.  The records' ``hw_model`` is the
default dispatcher's, the model their Advice fields were derived with.

``--workload lm`` switches from kernel families to whole-model decode:
each ``--config`` architecture (reduced for execution, full-sized for
the analytics) is served through the
:class:`~repro_torch.models.engine.DecodeEngine`, every layer's
attention through the flash-decode kernel, once per forced engine.  The
records key as ``lm-<config>`` and additionally carry the
prefill/decode phase split and the per-op model-scale ``verdict`` the
``model_verdict`` claim checks.

``--trace-out PATH`` exports the sweep's span timeline (virtual-clock
admissions, queue waits and batch launches, and the traced dispatch and
launch spans on the wall clock) as Chrome-trace JSON.  Records always
carry the compact ``trace`` reconciliation block.

``--tuned FILE`` loads a tuned.json into the default dispatcher, so
dispatch and the packed capacity use its tiles.  ``--online-tune`` adds
one ``engine='auto'`` session per kernel served by
:class:`~repro_torch.serving.router.OnlineKernelBatchExecutor`: a budgeted
UCB bandit (``repro_torch.tuning.online``, ``--tune-budget`` pulls per
key) re-tunes tiles from measured batch compute, warm-started from the
loaded cache.  These sessions land in ``BENCH_serve_<kernel>_online.json``
with a ``tuning`` block that the ``online_ceiling`` claim replays, and
the bandit's winners persist to ``<out>/tuned-online.json`` through the
cache's faster-wins merge.

Sessions run on the card; ``--device cpu`` runs the kernels' plain
versions on the CPU (the CPU tests' form).  Refused, naming their ROADMAP
Queue 1 item: ``--chaos`` (the elastic session, items 13-14),
``--slo-route`` (its router grows the mesh), ``--mesh N`` with N > 1 and
``--real`` (item 13).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ..core.dispatch import DEFAULT_DISPATCHER
from ..kernels import registry
from ..serving import (WORKLOADS, BatchPolicy, PoissonLoadGen, SLO,
                       SessionConfig, run_session)
from ..serving.session import BACKEND_FOR_DEVICE
from .common import bench_env, write_serving_json

#: Families swept by default: the elementwise suite the batcher packs
#: into one launch per batch; ``--kernels all`` sweeps every registered
#: family through the per-request fallback too.
DEFAULT_KERNELS = ("scale", "triad", "axpy")

#: Engines each session config is served under.  'auto' is not swept
#: separately: its resolution is recorded as ``engine_auto`` on every
#: record, and on memory-bound families it coincides with 'vector'.
ENGINES = ("vector", "matrix")

DEFAULT_OUT = "build/runs_torch"

#: Reference flags the port refuses, with the ROADMAP Queue 1 item each
#: waits for.
WAITING = {
    "chaos": "items 13-14 (the elastic session: sharding, runtime)",
    "slo_route": "item 13 (sharding: the router's mesh widths)",
    "mesh": "item 13 (sharding)",
    "real": "item 13 (sharding)",
}


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="repro_torch.bench serve", description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="poisson",
                   choices=tuple(WORKLOADS) + ("lm",),
                   help="traffic model, or 'lm' for whole-model decode "
                        "sessions (default poisson)")
    p.add_argument("--rate", type=float, default=None,
                   help="offered rate knob, requests/s (default 64; lm: 8)")
    p.add_argument("--duration", type=float, default=None,
                   help="session horizon in virtual seconds "
                        "(default 2; lm: 1)")
    p.add_argument("--kernels", default=None,
                   help="comma-separated families, or 'all' "
                        f"(default {','.join(DEFAULT_KERNELS)})")
    p.add_argument("--config", default="deepseek_7b",
                   help="comma-separated model configs for --workload lm "
                        "(underscores ok, unique prefixes ok; default "
                        "deepseek_7b)")
    p.add_argument("--prompt-len", type=int, default=8,
                   help="lm: prompt tokens per request (default 8)")
    p.add_argument("--gen", type=int, default=4,
                   help="lm: decode tokens per request (default 4)")
    p.add_argument("--size", type=int, default=65536,
                   help="per-request elements (default 65536)")
    p.add_argument("--dtype", default="float32",
                   help="request dtype (default float32)")
    p.add_argument("--seed", type=int, default=0,
                   help="loadgen seed; sessions replay exactly (default 0)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="continuous-batching size trigger "
                        "(default 8; lm: 4)")
    p.add_argument("--max-wait-ms", type=float, default=20.0,
                   help="continuous-batching age trigger (default 20)")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="end-to-end latency SLO (default 50; lm: 30000)")
    p.add_argument("--trace", default=None,
                   help="JSON trace path (required for --workload trace)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="export the sessions' span timeline as "
                        "Chrome-trace JSON; --trace names the *workload "
                        "input*, this names the observability output")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where sessions run: the card (default), or the "
                        "CPU with the kernels' plain versions")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help=f"record directory (default {DEFAULT_OUT})")
    p.add_argument("--tuned", default=None,
                   help="tuned.json for tile-aware packing/dispatch")
    p.add_argument("--online-tune", action="store_true",
                   help="add one engine='auto' session per kernel whose "
                        "tiles are re-tuned live by the budgeted UCB "
                        "bandit; records land in "
                        "BENCH_serve_<kernel>_online.json and the winners "
                        "in <out>/tuned-online.json")
    p.add_argument("--tune-budget", type=int, default=8,
                   help="online bandit exploration pulls per (kernel, "
                        "engine, dtype, shard) key (default 8)")
    # refused: each waits for a ROADMAP item (WAITING)
    p.add_argument("--mesh", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--chaos", default=None, help=argparse.SUPPRESS)
    p.add_argument("--real", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--slo-route", action="store_true",
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _refuse_waiting(args: argparse.Namespace) -> None:
    given = {"chaos": args.chaos is not None, "slo_route": args.slo_route,
             "mesh": args.mesh > 1, "real": args.real}
    for name, on in given.items():
        if on:
            flag = "--" + name.replace("_", "-")
            raise SystemExit(f"{flag} is not ported yet: it waits for "
                             f"ROADMAP Queue 1 {WAITING[name]}")


def _resolve_configs(spec: str) -> List[str]:
    """Resolve a ``--config`` list against the architecture registry.

    Accepts the registry's dash-separated names, underscore spellings
    (``deepseek_7b``), and unique prefixes."""
    from ..configs import ARCHS
    out = []
    for raw in (s.strip() for s in spec.split(",") if s.strip()):
        name = raw.replace("_", "-")
        if name in ARCHS:
            out.append(name)
            continue
        matches = sorted(k for k in ARCHS if k.startswith(name))
        if len(matches) == 1:
            out.append(matches[0])
        elif not matches:
            raise SystemExit(f"unknown model config {raw!r}; have "
                             f"{sorted(ARCHS)}")
        else:
            raise SystemExit(f"ambiguous model config {raw!r}: {matches}")
    return out


def _row(kernel: str, workload: str, summary, record) -> str:
    return (f"{kernel},{record['engine']},{workload},"
            f"{summary.completed},{summary.p50_ms:.3f},"
            f"{summary.p99_ms:.3f},{summary.goodput_rps:.3f},"
            f"{summary.slo_attainment:.4f}")


def _serve_lm(args: argparse.Namespace, env: dict) -> int:
    """The ``--workload lm`` sweep: one decode-engine session per (model
    config, forced engine), reduced execution with full-size analytics
    (the model-scale verdict)."""
    from ..configs import get_arch, reduced
    from ..serving.lm import LMDecodeExecutor

    configs = _resolve_configs(args.config)
    policy = BatchPolicy(max_batch=args.max_batch,
                         max_wait_s=args.max_wait_ms / 1e3)
    slo = SLO(latency_ms=args.slo_ms)
    print("kernel,engine,workload,completed,p50_ms,p99_ms,goodput_rps,"
          "slo_attainment")
    for name in configs:
        full = get_arch(name)
        kernel = f"lm-{full.name}"
        records = []
        for engine in ENGINES:
            executor = LMDecodeExecutor(
                reduced(full), max_batch=args.max_batch, prompt_len=args.prompt_len,
                max_gen=args.gen, seed=args.seed, engine=engine,
                verdict_cfg=full, device=args.device)
            # the lm source is built here, not via make_loadgen: the
            # record's workload field says 'lm' while the arrivals are
            # plain seeded Poisson traffic over the decode kernel
            source = PoissonLoadGen(kernel=kernel, rate_rps=args.rate,
                                    size=args.gen, dtype=args.dtype,
                                    seed=args.seed)
            cfg = SessionConfig(
                kernel=kernel, workload="lm", engine=engine,
                rate_rps=args.rate, duration_s=args.duration,
                size=args.gen, dtype=args.dtype, seed=args.seed,
                policy=policy, slo=slo, device=args.device,
                backend=BACKEND_FOR_DEVICE[args.device])
            _, summary, record = run_session(cfg, executor=executor,
                                             source=source)
            del executor
            records.append(record)
            print(_row(kernel, "lm", summary, record))
        path = write_serving_json(kernel, records, args.out, env=env)
        print(f"# wrote {path}")
    return 0


def _serve_kernels(args: argparse.Namespace, env: dict) -> int:
    """One session per (kernel, forced engine) under the chosen workload."""
    explicit = args.kernels is not None and args.kernels != "all"
    names = (tuple(args.kernels.split(",")) if explicit
             else registry.names() if args.kernels == "all"
             else DEFAULT_KERNELS)
    unknown = sorted(set(names) - set(registry.names()))
    if unknown:
        raise SystemExit(f"unknown kernel(s) {unknown}; have "
                         f"{sorted(registry.names())}")
    trace = None
    if args.workload == "trace":
        # parse the trace once; it names its own kernels, so reconcile
        # with the sweep list up front instead of failing mid-sweep on
        # the first family the trace doesn't cover
        from ..serving import TraceLoadGen, load_trace
        trace = load_trace(args.trace)
        available = {r.kernel for r in trace.requests}
        if explicit:
            missing = sorted(set(names) - available)
            if missing:
                raise SystemExit(
                    f"trace {args.trace!r} holds no requests for "
                    f"kernel(s) {missing} (has {sorted(available)})")
        else:
            names = tuple(k for k in names if k in available)
            if not names:
                raise SystemExit(
                    f"trace {args.trace!r} covers no registered kernel "
                    f"(has {sorted(available)})")
    policy = BatchPolicy(max_batch=args.max_batch,
                         max_wait_s=args.max_wait_ms / 1e3)
    slo = SLO(latency_ms=args.slo_ms)
    print("kernel,engine,workload,completed,p50_ms,p99_ms,goodput_rps,"
          "slo_attainment")
    online_entries = []
    for kernel in names:
        records = []
        # per-kernel view of the once-parsed trace (None for the
        # synthetic workloads: run_session builds those generators)
        source = None if trace is None else TraceLoadGen(
            requests=[r for r in trace.requests if r.kernel == kernel])
        for engine in ENGINES:
            cfg = SessionConfig(
                kernel=kernel, workload=args.workload, engine=engine,
                rate_rps=args.rate, duration_s=args.duration,
                size=args.size, dtype=args.dtype, seed=args.seed,
                policy=policy, slo=slo, trace_path=args.trace,
                device=args.device,
                backend=BACKEND_FOR_DEVICE[args.device])
            _, summary, record = run_session(cfg, source=source)
            records.append(record)
            print(_row(kernel, args.workload, summary, record))
        path = write_serving_json(kernel, records, args.out, env=env)
        print(f"# wrote {path}")
        if args.online_tune:
            record, summary, entries = _online_session(args, kernel, policy,
                                                       slo, source)
            online_entries.extend(entries)
            print(_row(kernel, args.workload, summary, record))
            path = write_serving_json(kernel, [record], args.out, env=env,
                                      suffix="_online")
            print(f"# wrote {path}")
    if online_entries:
        print(f"# wrote {_persist_online(args.out, online_entries)}")
    return 0


def _online_session(args: argparse.Namespace, kernel: str,
                    policy: BatchPolicy, slo: SLO, source):
    """One ``--online-tune`` session: auto-routed engine, live bandit.

    Builds the tuner/executor stack here (rather than letting
    ``run_session`` own it) so the sweep can persist the bandit's winners
    after the session.
    """
    from ..serving.router import OnlineKernelBatchExecutor
    from ..tuning.online import OnlineTuner

    tuner = OnlineTuner(args.tune_budget,
                        cache=DEFAULT_DISPATCHER.tuning.cache,
                        hw_model=DEFAULT_DISPATCHER.hw.name)
    backend = BACKEND_FOR_DEVICE[args.device]
    executor = OnlineKernelBatchExecutor(
        engine="auto", max_batch=args.max_batch, seed=args.seed,
        backend=backend, tuner=tuner)
    cfg = SessionConfig(
        kernel=kernel, workload=args.workload, engine="auto",
        rate_rps=args.rate, duration_s=args.duration, size=args.size,
        dtype=args.dtype, seed=args.seed, policy=policy, slo=slo,
        trace_path=args.trace, online_tune=True,
        tune_budget=args.tune_budget, device=args.device, backend=backend)
    _, summary, record = run_session(cfg, executor=executor, source=source)
    return record, summary, tuner.to_entries()


def _persist_online(out_dir: str, entries) -> str:
    """Persist the sweep's online winners to ``<out>/tuned-online.json``.

    Faster-wins merge against the cache the sessions were warm-started
    from: an online entry (a batch's completed time, host path included,
    above the tuner's kernel times) can only *add* keys that cache lacks,
    never displace a kernel-timed winner with a slower-clock measurement.
    """
    import os

    from ..tuning.cache import TuningCache

    online = TuningCache()
    for entry in entries:
        online.add(entry)
    loaded = DEFAULT_DISPATCHER.tuning.cache
    # merge() mutates its receiver, so fold into a copy: the default
    # dispatcher's cache must not grow online entries
    merged = TuningCache(list(loaded) if loaded is not None else (),
                         fingerprint=(loaded.fingerprint
                                      if loaded is not None else None))
    merged.merge(online)
    return merged.save(os.path.join(out_dir, "tuned-online.json"))


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse(argv)
    _refuse_waiting(args)
    lm = args.workload == "lm"
    # per-workload defaults, the reference's: lm sessions take lighter
    # traffic and an SLO that measures attainment on a slow decode step
    if args.rate is None:
        args.rate = 8.0 if lm else 64.0
    if args.duration is None:
        args.duration = 1.0 if lm else 2.0
    if args.max_batch is None:
        args.max_batch = 4 if lm else 8
    if args.slo_ms is None:
        args.slo_ms = 30000.0 if lm else 50.0
    if args.workload == "trace" and not args.trace:
        raise SystemExit("--workload trace requires --trace PATH")
    if args.online_tune and lm:
        raise SystemExit("--online-tune is not supported for --workload lm "
                         "(kernel sessions only)")
    if args.tune_budget < 1:
        raise SystemExit("--tune-budget must be >= 1")
    if args.tuned:
        DEFAULT_DISPATCHER.load_tuned(args.tuned)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no card (torch.cuda.is_available() is false); "
                         "pass --device cpu to run the plain versions")
    # IEEE float32 everywhere: no TF32 in the matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = bench_env(args.device, DEFAULT_DISPATCHER.hw.name)
    sweep = _serve_lm if lm else _serve_kernels
    if not args.trace_out:
        return sweep(args, env)
    from ..obs.trace import capture, write_chrome_trace
    with capture() as view:
        status = sweep(args, env)
    write_chrome_trace(args.trace_out, view.events,
                       meta={"source": "repro_torch.bench.serve",
                             "workload": args.workload, "seed": args.seed,
                             "device": args.device})
    print(f"# wrote {args.trace_out}")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
