"""Deterministic Markdown rendering of the verified evidence (paper §5).

Turns loaded record sets + claim results into:

* ``REPORT.md`` -- the top-level evidence table: per kernel family, how
  many records were checked, per-claim violation counts (the Eq. 23/24
  ceiling column must read 0 everywhere for the paper's thesis to
  hold), and the worst matrix-engine ceiling observed.
* ``docs/benchmarks/<kernel>.md`` -- one page per kernel family with
  the full sweep table and its environment metadata,
* a **serving** section (serving records from ``serve``): per-session
  latency percentiles and goodput with a vpu-vs-mxu-under-load
  comparison per kernel, plus ``docs/benchmarks/<kernel>-serving.md``
  session pages,
* an **online tuning** section (records with a ``tuning`` payload from
  ``serve --online-tune``): per-session bandit decisions, regret
  against the running best, and the router's width trajectory, all
  replayed by the ``online_ceiling`` claim — plus per-key bandit
  tables and the router decision log on
  ``docs/benchmarks/<kernel>-serving-online.md`` pages,
* an **observability** section (schema-7 ``trace`` blocks): the
  per-(kernel, engine) roofline gauge — achieved GB/s against the
  Eq. 4 bound and achieved FLOP/s against the Eq. 3 ceiling, as
  recorded by the live counters — plus per-session span-vs-log
  reconciliation counts, all claim-checked by
  ``trace_reconciliation``.

Rendering is a pure function of the records -- no timestamps, no
environment probes at render time -- so regenerating the report from
unchanged records is byte-identical.  The reference package's own records
(``runs/``) render to the bytes its renderer writes; the port's records
(an ``env`` with a ``torch`` version) render in the port's voice: its
commands, the kernel's own median (``us_per_call``) in the time column,
and its methodology (:data:`PORT_VOICE`).

Mesh sweep sets (``-mesh<N>``) render the **sharded execution** section
and mesh kernel pages (split kind, halo, traffic overhead, per-shard
floor, shard claims); points measured on ranks (``mesh_exec``, from
``--real``) add the **measured collectives** block and their pages the
mesh wall, collective and skew columns; chaos sessions render **serving
under failure**.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
from typing import Dict, List, Sequence, Tuple

from ..core.balance import machine_balance
from .claims import (CLAIMS, ClaimResult, ceiling_bound, check_record,
                     check_serving_record, hw_for)
from .records import BenchRecord, RecordSet, ServingRecord

__all__ = ["PORT_VOICE", "REFERENCE_VOICE", "Voice", "page_name",
           "render_kernel_page", "render_report", "render_serving_page",
           "write_report"]

@dataclasses.dataclass(frozen=True)
class Voice:
    """The words a report uses for the package whose records it renders:
    its commands and module prefix, the label of the timed median, and
    what its methodology says about the numbers."""

    pkg: str            # module prefix: 'repro' or 'repro_torch'
    regen: str          # the command that regenerates the report
    serve: str          # the command that produces serving sessions
    tune: str           # the command that produces tuned.json
    sweep: str          # the command that produces sweep records
    sweep_trace: str    # the traced sweep command
    records: str        # what the report is generated from
    time_label: str     # kernel-page header of the timed median
    pred_label: str     # kernel-page header of the byte-bound time
    online_clock: str   # what a warm-start entry's committed us measured
    env_columns: Tuple[Tuple[str, str], ...]   # (header, env key)
    methodology: Tuple[str, ...]


#: The reference package's voice: its records render to its own bytes.
REFERENCE_VOICE = Voice(
    pkg="repro",
    regen="python -m benchmarks.run report",
    serve="python -m benchmarks.run serve",
    tune="python -m benchmarks.run tune",
    sweep="python -m benchmarks.run sweep",
    sweep_trace="benchmarks.run sweep --trace out.json",
    records="the committed `runs/BENCH_*.json` records",
    time_label="ref µs (median)",
    pred_label="pred µs v5e",
    online_clock=("offline proxy timing — a different clock than the "
                  "observed interpret walls"),
    env_columns=(("jax", "jax"), ("device", "device"),
                 ("interpret", "interpret")),
    methodology=(
        "- `ref_us_per_call` is the median XLA-CPU wall time of the "
        "pure-jnp oracle (the hardware-relative signal available "
        "off-TPU); Pallas engine variants run in interpret mode and are "
        "checked for correctness, not timed.",
        "- `pred_us_v5e` is the analytic memory-floor time Q / B_mem on "
        "the TPU v5e model (819 GB/s HBM).",
        "- The MXU ceiling is the advisor's tightest applicable bound: "
        "Eq. 17 (fully overlapped, 1.0x) under the default overlap "
        "assumption, never above Eq. 23 (2 − 2/(1+α)) or Eq. 24 "
        "(1 + I/B).",
        "- `tile config` columns show the autotuned tile parameters a "
        "point launched with (`—` = static defaults); deltas come from "
        "the tuner's pure-XLA proxy timings, never from interpret-mode "
        "Pallas (whose wall times the cache refuses to persist).",
        "- Serving sessions run on a virtual clock: arrivals are seeded "
        "and replayable, batch compute is measured wall time folded "
        "back into the clock — so queueing compounds under load, but "
        "absolute latencies remain machine-relative (compare p99/goodput "
        "across runs of the same machine, not across platforms).",
    ),
)

#: The port's voice, for records whose ``env`` names a torch version.
PORT_VOICE = Voice(
    pkg="repro_torch",
    regen="python -m repro_torch.bench report",
    serve="python -m repro_torch.bench serve",
    tune="python -m repro_torch.bench tune",
    sweep="python -m repro_torch.bench kernels",
    sweep_trace="repro_torch.bench kernels --trace out.json",
    records="the `BENCH_*.json` records of its directory",
    time_label="µs (median)",
    pred_label="pred µs",
    online_clock=("kernel timing by the offline tuner — a different clock "
                  "than the observed batch walls, which include the "
                  "host's launch path"),
    env_columns=(("torch", "torch"), ("device", "device"),
                 ("card", "card")),
    methodology=(
        "- `µs (median)` is the engine kernel's own median "
        "(`us_per_call`): CUDA-event time per call on the card "
        "(`device: gpu`), or host wall time of the kernel's plain "
        "PyTorch version on the CPU (`device: cpu`, not a device "
        "number). `ref_us_per_call` in the records is the plain "
        "oracle's time.",
        "- `pred_us` is the analytic memory-floor time Q / B_mem on the "
        "record's hardware model (`hw model` below).",
        "- The MXU ceiling is the advisor's tightest applicable bound: "
        "Eq. 17 (fully overlapped, 1.0x) under the default overlap "
        "assumption, never above Eq. 23 (2 − 2/(1+α)) or Eq. 24 "
        "(1 + I/B).",
        "- `tile config` columns show the autotuned tile parameters a "
        "point launched with (`—` = static defaults); deltas come from "
        "the tuner's CUDA-event timings of the hand-written kernels on "
        "the card, never from the plain versions on the CPU (whose "
        "timings the cache refuses to persist).",
        "- Serving sessions run on a virtual clock: arrivals are seeded "
        "and replayable, batch compute is the launch's measured "
        "completed time folded back into the clock — so queueing "
        "compounds under load, but absolute latencies remain "
        "machine-relative (compare p99/goodput across runs of the same "
        "card, not across platforms).",
    ),
)


def _voice(recsets: Sequence[RecordSet]) -> Voice:
    """The port's voice when any set was written by the port."""
    return (PORT_VOICE if any("torch" in rs.env for rs in recsets)
            else REFERENCE_VOICE)


def _shard_floor(spec: Dict):
    """The per-shard memory floor a shard_spec records: the reference's
    ``pred_shard_us_v5e`` or the port's ``pred_shard_us``."""
    return spec.get("pred_shard_us", spec.get("pred_shard_us_v5e"))


def _env_cell(env: Dict, key: str) -> str:
    value = env.get(key)
    if value is None:
        return "—"
    return _fmt(value) if isinstance(value, bool) else str(value)


def _fmt(x, digits: int = 4) -> str:
    """Stable numeric formatting (no locale, no float repr drift)."""
    if x is None:
        return "—"
    if isinstance(x, bool):
        return "yes" if x else "no"
    if isinstance(x, int):
        return str(x)
    return f"{x:.{digits}g}"


def page_name(rs: RecordSet) -> str:
    """The docs/benchmarks/ page filename for one record set.

    Serving sets get a ``-serving`` suffix, online-tuned serving sets
    (every record carries a ``tuning`` payload) ``-serving-online``,
    mesh sets a ``-mesh<N>`` suffix (composable: a mesh serving sweep
    is ``<kernel>-serving-mesh<N>.md``), so one kernel family's
    evidence pages never collide.
    """
    suffix = "-serving" if rs.kind == "serving" else ""
    if _is_online(rs):
        suffix += "-online"
    if rs.mesh_devices > 1:
        suffix += f"-mesh{rs.mesh_devices}"
    return f"{rs.kernel}{suffix}.md"


def _is_online(rs: RecordSet) -> bool:
    """True when the set holds online-tuned sessions (tuning payloads)."""
    return rs.kind == "serving" and \
        any(rec.tuning for rec in rs.records)


def _set_label(rs: RecordSet) -> str:
    """The human-facing label for one record set in shared tables."""
    parts = []
    if rs.kind == "serving":
        parts.append("serving")
    if _is_online(rs):
        parts.append("online")
    if rs.mesh_devices > 1:
        parts.append(f"mesh {rs.mesh_devices}")
    return rs.kernel + (f" ({', '.join(parts)})" if parts else "")


def _check_set(rs: RecordSet) -> List[Tuple[BenchRecord,
                                            Tuple[ClaimResult, ...]]]:
    hw = hw_for(rs)
    check = check_serving_record if rs.kind == "serving" else check_record
    return [(rec, check(rec, hw)) for rec in rs.records]


def _claim_cell(results: Sequence[ClaimResult], claim: str) -> str:
    fails = sum(1 for r in results if r.claim == claim and not r.passed)
    return "0 ✅" if fails == 0 else f"{fails} ❌"


def _tile_cell(rec: BenchRecord) -> str:
    """'block_rows=128, lanes=512' for a tuned point, '—' for defaults."""
    params = rec.tile_params
    if not params:
        return "—"
    return ", ".join(f"{k}={v}" for k, v in sorted(params.items()))


def _tuned_delta_cell(rec: BenchRecord) -> str:
    """Tuner-measured gain of the tuned tiles over the static defaults."""
    speedup = rec.tuned_speedup
    if speedup is None:
        return "—"
    return f"{(speedup - 1.0) * 100:+.1f}%"


def render_report(recsets: Sequence[RecordSet]) -> str:
    """Render REPORT.md: the claim-verification summary across families.

    One row per kernel family; the *ceiling* column counts Eq. 23/24
    violations (must be 0), *routing* counts §6 auto-dispatch
    mismatches, *accuracy* counts oracle-tolerance failures, and
    *boundedness* counts Eq. 4 classification mismatches.
    """
    voice = _voice(recsets)
    bench = [rs for rs in recsets
             if rs.kind == "bench" and rs.mesh_devices == 1]
    sharded = [rs for rs in recsets
               if rs.kind == "bench" and rs.mesh_devices > 1]
    serving = [rs for rs in recsets if rs.kind == "serving"]
    lines: List[str] = []
    add = lines.append
    add("# Evidence report — Can Tensor Cores Benefit Memory-Bound "
        "Kernels? (No!)")
    add("")
    add(f"Generated by `{voice.regen}` from {voice.records};")
    add("regeneration from unchanged records is byte-identical (no "
        "timestamps).")
    add("")
    add("## Claim verification")
    add("")
    add("Every record is re-joined to the analytic layer "
        f"(`{voice.pkg}.core.advisor`/`bounds`/`balance`) and checked against "
        "the paper's claims: the matrix-engine speedup ceiling never "
        "exceeds Eq. 23/24, `engine='auto'` routes memory-bound work to "
        "the vector engine (§6), engine variants match the oracle, and "
        "the recorded boundedness matches a fresh Eq. 4 derivation.")
    add("")
    add("| kernel | records | ceiling (Eq. 23/24) | routing (§6) | "
        "accuracy | boundedness (Eq. 4) | max MXU ceiling | tightest "
        "bound |")
    add("|---|---|---|---|---|---|---|---|")
    total_records = 0
    total_violations: Dict[str, int] = {c: 0 for c in CLAIMS}
    for rs in bench:
        checked = _check_set(rs)
        flat = [cr for _, crs in checked for cr in crs]
        hw = hw_for(rs)
        max_ceiling = max(rec.mxu_ceiling for rec in rs.records)
        tightest = min(ceiling_bound(rec.intensity, hw)
                       for rec in rs.records if rec.memory_bound) \
            if any(r.memory_bound for r in rs.records) else hw.alpha
        cells = [rs.kernel, str(len(rs.records))]
        cells += [_claim_cell(flat, c) for c in CLAIMS]
        cells += [f"{_fmt(max_ceiling)}x", f"{_fmt(tightest)}x"]
        add("| " + " | ".join(cells) + " |")
        total_records += len(rs.records)
        for c in CLAIMS:
            total_violations[c] += sum(
                1 for r in flat if r.claim == c and not r.passed)
    add("")
    worst = sum(total_violations.values())
    if worst == 0:
        add(f"**{total_records} records across {len(bench)} kernel "
            "families; zero claim violations.** The measured story "
            "matches the theory: matrix engines never beat the Eq. 23/24 "
            "ceiling on memory-bound kernels, so the vector engine is "
            "the right tool (paper §6).")
    else:
        add(f"**{worst} claim violation(s) across {total_records} "
            "records — see per-kernel pages.**")
    add("")
    tuned = [(rs, rec) for rs in bench for rec in rs.records
             if rec.tile_config]
    if tuned:
        add("## Tuned tile configurations")
        add("")
        add("Sweep points launched with autotuned tiles "
            f"(`{voice.tune}`); the delta is the "
            "tuner's own tuned-vs-default wall-time measurement, per "
            "(kernel, engine, dtype) — the bandwidth-saturation "
            "tightening the Eq. 23/24 check rides on.")
        add("")
        add("| kernel | engine | dtype | tile config | tuned Δ vs "
            "default |")
        add("|---|---|---|---|---|")
        seen = set()
        for rs, rec in tuned:
            key = (rec.kernel, rec.engine, rec.dtype)
            if key in seen:
                continue
            seen.add(key)
            add(f"| {rec.kernel} | {rec.engine} | {rec.dtype} | "
                f"{_tile_cell(rec)} | {_tuned_delta_cell(rec)} |")
        add("")
    if sharded:
        lines.extend(_sharded_section(sharded, bench, voice))
    if serving:
        lines.extend(_serving_section(serving, voice))
        lines.extend(_failure_section(serving, voice))
        lines.extend(_verdict_section(serving, voice))
        lines.extend(_online_section(serving, voice))
    lines.extend(_observability_section(recsets, voice))
    add("## Methodology")
    add("")
    lines.extend(voice.methodology)
    add("")
    add("## Environment")
    add("")
    heads = " | ".join(h for h, _ in voice.env_columns)
    add(f"| kernel | schema | {heads} | hw model |")
    add("|---|---|" + "---|" * len(voice.env_columns) + "---|")
    for rs in recsets:
        cells = [_env_cell(rs.env, k) for _, k in voice.env_columns]
        add(f"| {_set_label(rs)} | {rs.schema} | {' | '.join(cells)} "
            f"| {rs.env.get('hw_model', '—')} |")
    add("")
    add("## Per-kernel pages")
    add("")
    for rs in recsets:
        add(f"- [{_set_label(rs)}](docs/benchmarks/{page_name(rs)})")
    add("")
    return "\n".join(lines)


def _serving_claim_verdict(crs: Sequence[ClaimResult]) -> str:
    failed = [c.claim for c in crs if not c.passed]
    return "✅" if not failed else "❌ " + ",".join(failed)


def _sharded_section(sharded: Sequence[RecordSet],
                     bench: Sequence[RecordSet], voice: Voice) -> List[str]:
    """The REPORT.md sharded-execution block: mesh points + overheads.

    Joins each mesh point back to its single-device twin so the scaling
    story is explicit: the per-shard memory floor drops by ~N x (modulo
    the halo/replication overhead column), while the matrix-engine
    ceiling column stays pinned at the per-device Eq. 23/24 value --
    scaling out buys bandwidth, the matrix engine still buys nothing.
    """
    base_floor = {}
    for rs in bench:
        for rec in rs.records:
            base_floor[(rec.kernel, rec.size, rec.dtype)] = rec.pred_us
    lines: List[str] = []
    add = lines.append
    add("## Sharded execution")
    add("")
    if voice is REFERENCE_VOICE:
        add("Schema-5/6 mesh records from `python -m benchmarks.run sweep "
            "--mesh N [--real]`: every engine variant executed shard by "
            "shard (`repro.sharding` — data/rowblock/head splits, halo "
            "rows exchanged for stencils) and re-verified.")
    else:
        add(f"Schema-5 mesh records from `{voice.sweep} --mesh N`: every "
            "engine variant executed shard by shard, one shard after "
            f"another on one device (`{voice.pkg}.sharding` — "
            "data/rowblock/head splits, halo rows sliced for stencils) "
            "and re-verified.")
    lines[-1] += (" The *shard claims* "
                  "hold the paper's per-device verdict on every shard: the "
                  "worst shard's intensity stays below the vector machine "
                  "balance (per-shard **bandwidth** still sets the roof), "
                  "the recorded MXU ceiling obeys Eq. 23/24 at the "
                  "per-shard intensity, and the aggregate bytes moved are "
                  "consistent with the unsharded kernel plus declared "
                  "halo/replication overhead.")
    add("")
    add("| kernel | mesh | engine | size | dtype | kind | halo | "
        "agg/total traffic | per-shard floor µs | 1-dev floor µs | "
        "MXU ceiling | claims |")
    add("|---|---|---|---|---|---|---|---|---|---|---|---|")
    points = 0
    fails = 0
    for rs in sharded:
        for rec, crs in _check_set(rs):
            points += 1
            fails += sum(1 for c in crs if not c.passed)
            spec = dict(rec.shard_spec or {})
            total = float(spec.get("total_bytes", 0.0)) or None
            agg = float(spec.get("agg_bytes", 0.0))
            overhead = (agg / total) if total else None
            add("| " + " | ".join([
                rec.kernel, f"{rec.mesh_devices}-way", rec.engine,
                str(rec.size), rec.dtype, str(spec.get("kind", "—")),
                str(spec.get("halo", "—")),
                f"{_fmt(overhead)}x" if overhead is not None else "—",
                _fmt(_shard_floor(spec)),
                _fmt(base_floor.get((rec.kernel, rec.size, rec.dtype))),
                f"{_fmt(rec.mxu_ceiling)}x",
                _serving_claim_verdict(crs),
            ]) + " |")
    add("")
    if fails == 0:
        add(f"**{points} mesh sweep points; zero shard-claim "
            "violations.** The Eq. 23/24 verdict survives aggregation "
            "across the mesh: every shard is still memory-bound, so "
            "scaling out divides the memory floor by the shard count "
            "(minus halo overhead) while the matrix engine's ceiling "
            "stays where the paper put it.")
    else:
        add(f"**{fails} shard-claim violation(s) across {points} mesh "
            "points — see per-kernel mesh pages.**")
    add("")
    lines.extend(_collectives_section(sharded, voice))
    return lines


def _collectives_section(sharded: Sequence[RecordSet],
                         voice: Voice) -> List[str]:
    """The REPORT.md measured-collectives block (schema-6 ``--real``).

    One row per mesh point measured on ranks: the measured wall of the
    whole step, the exchange alone (0 us whenever the plan's
    ``wire_bytes`` is 0), the virtual slowest-shard clock for the same
    point, and their skew; the overlap probe, where the sweep ran it,
    closes the section.
    """
    rows = [(rs, rec) for rs in sharded for rec in rs.records
            if rec.mesh_exec]
    if not rows:
        return []
    lines: List[str] = []
    add = lines.append
    add("### Measured collectives")
    add("")
    if voice is REFERENCE_VOICE:
        add("Schema-6 points from `python -m benchmarks.run sweep --mesh N "
            "--real`: the same shard plan lowered to one `shard_map` "
            "program over N real XLA host devices, halo rows crossing the "
            "mesh via `ppermute` rings. *coll µs* times the ring alone (a "
            "twin program that runs only the exchange), so a zero-wire "
            "plan must — and does — measure 0. *skew* is measured wall "
            "over the virtual max-over-shards clock: the host devices "
            "share one socket's bandwidth, so walls land well above the "
            "virtual model — the mesh run is a correctness + collective "
            "measurement, not a throughput claim (§4.1: what matters is "
            "that the exchange can hide behind compute).")
    else:
        add(f"Schema-6 points from `{voice.sweep} --mesh N --real`: the "
            "same shard plan run on N ranks at once (gloo processes, "
            "every one on the same card), halo rows staged through "
            "pinned host memory between neighbours. *coll µs* times the "
            "exchange alone, so a zero-wire plan measures 0. *skew* is "
            "the measured wall over the virtual slowest-shard clock: the "
            "ranks are time-sliced on one card, so walls land near the "
            "sum of the shards plus the exchange — a correctness + "
            "collective measurement, not a throughput claim.")
    add("")
    add("| kernel | mesh | engine | size | dtype | wire bytes | "
        "coll µs | mesh wall µs | virtual µs | skew | mesh max err |")
    add("|---|---|---|---|---|---|---|---|---|---|---|")
    for rs, rec in rows:
        me = dict(rec.mesh_exec)
        spec = dict(rec.shard_spec or {})
        add("| " + " | ".join([
            rec.kernel, f"{me.get('devices', rec.mesh_devices)}-way",
            rec.engine, str(rec.size), rec.dtype,
            _fmt(spec.get("wire_bytes")),
            _fmt(me.get("collective_us")),
            _fmt(me.get("mesh_wall_us")),
            _fmt(me.get("virtual_us")),
            f"{_fmt(me.get('skew'))}x",
            _fmt(me.get("mesh_max_err"), 3),
        ]) + " |")
    add("")
    probes = {}
    for rs in sharded:
        probe = rs.env.get("collective_overlap")
        if isinstance(probe, dict):
            key = (probe.get("devices"), str(probe.get("shape")))
            probes[key] = probe
    for _, probe in sorted(probes.items(), key=lambda kv: str(kv[0])):
        add(f"Overlap probe ({probe.get('devices')} devices, shape "
            f"{probe.get('shape')}): ring all-gather matmul "
            f"{_fmt(probe.get('ring_us'))} µs vs serialized "
            f"{_fmt(probe.get('serialized_us'))} µs "
            f"(gain {_fmt(probe.get('overlap_gain'))}x), row-parallel "
            f"{_fmt(probe.get('rowparallel_us'))} µs — the resurrected "
            "`collective_matmul` variants validated against the "
            "unsharded product on the live mesh.")
        add("")
    return lines


def _serving_section(serving: Sequence[RecordSet],
                     voice: Voice) -> List[str]:
    """The REPORT.md serving block: session table + VPU-vs-MXU columns."""
    lines: List[str] = []
    add = lines.append
    add("## Serving under load")
    add("")
    add(f"Schema-4 session records from `{voice.serve}`: "
        "seeded, replayable traffic (Poisson / bursty / closed-loop / "
        "trace) driven through the continuous-batching scheduler, with "
        "engine selection by the dispatcher's memoized Advice. Each "
        "session is re-verified here: §6 routing under load, Eq. 4 "
        "boundedness, percentile monotonicity, and goodput/SLO "
        "consistency.")
    add("")
    add("| kernel | workload | engine | rate /s | completed | mean "
        "batch | p50 ms | p99 ms | goodput /s | SLO attain | claims |")
    add("|---|---|---|---|---|---|---|---|---|---|---|")
    sessions = 0
    fails = 0
    for rs in serving:
        for rec, crs in _check_set(rs):
            sessions += 1
            fails += sum(1 for c in crs if not c.passed)
            add("| " + " | ".join([
                rec.kernel, rec.workload, rec.engine,
                _fmt(rec.rate_rps), f"{rec.completed}/{rec.offered}",
                _fmt(rec.mean_batch), _fmt(rec.p50_ms),
                _fmt(rec.p99_ms), _fmt(rec.goodput_rps),
                _fmt(rec.slo_attainment), _serving_claim_verdict(crs),
            ]) + " |")
    add("")
    if fails == 0:
        add(f"**{sessions} serving sessions; zero serving-claim "
            "violations.** The §6 routing story survives steady-state "
            "traffic: memory-bound request streams auto-route to the "
            "vector engine.")
    else:
        add(f"**{fails} serving-claim violation(s) across {sessions} "
            "sessions — see per-kernel serving pages.**")
    add("")
    pairs = _engine_pairs(serving)
    if pairs:
        add("### VPU vs MXU under load")
        add("")
        add("The paper's question in steady state: the same request "
            "stream served once with the vector engine forced and once "
            "with the matrix engine forced. On memory-bound kernels the "
            "matrix engine buys no tail latency and no goodput — the "
            "per-call Eq. 23/24 verdict, visible at the p99.")
        add("")
        add("| kernel | workload | size | dtype | mesh | p99 vpu ms | "
            "p99 mxu ms | mxu/vpu p99 | goodput vpu /s | goodput mxu "
            "/s |")
        add("|---|---|---|---|---|---|---|---|---|---|")
        for (kernel, workload, size, dtype, shards), (vpu, mxu) in pairs:
            ratio = (mxu.p99_ms / vpu.p99_ms) if vpu.p99_ms > 0 else None
            add("| " + " | ".join([
                kernel, workload, str(size), dtype,
                f"{shards}-way" if shards > 1 else "—",
                _fmt(vpu.p99_ms), _fmt(mxu.p99_ms),
                f"{_fmt(ratio)}x" if ratio is not None else "—",
                _fmt(vpu.goodput_rps), _fmt(mxu.goodput_rps),
            ]) + " |")
        add("")
    return lines


def _failure_section(serving: Sequence[RecordSet],
                     voice: Voice) -> List[str]:
    """The REPORT.md serving-under-failure block (chaos sessions).

    One row per session carrying an ``events`` payload
    (``repro.serving.ElasticSession`` under a seeded fault/resize
    injector): the chaos spec, how many failures were re-dispatched and
    resizes replayed, availability against its target, total recovery
    latency, and the chaos p99 against the fault-free replay's — with
    the ``elastic_integrity`` claim certifying the checksums bit-equal.
    Event logs live on the ``<kernel>-serving.md`` pages.
    """
    rows = [(rec, crs) for rs in serving for rec, crs in _check_set(rs)
            if rec.events]
    if not rows:
        return []
    lines: List[str] = []
    add = lines.append
    add("## Serving under failure")
    add("")
    add(f"Chaos sessions (`{voice.serve} --chaos "
        "<spec>`): the same seeded traffic served by an elastic session "
        "while a deterministic injector kills shards mid-batch and "
        "resizes the mesh under load. A killed shard's ShardPlan ranges "
        "are re-dispatched on the surviving resources (bit-exact, "
        "recovery charged to the clock); each resize replays "
        "`runtime/elastic.mesh_transition_plan` and re-verifies the "
        "served fingerprints at the new width. The `elastic_integrity` "
        "claim holds the contract: the chaos run's result checksum "
        "equals the fault-free replay's **exactly** — failures and "
        "resizes move latency, never results — while availability and "
        "p99 stay inside their bounds and the ceiling/routing claims "
        "keep passing on the same records.")
    add("")
    add("| kernel | engine | mesh | chaos spec | failures | resizes | "
        "availability | recovery ms | p99 ms | fault-free p99 ms | "
        "checksum | claims |")
    add("|---|---|---|---|---|---|---|---|---|---|---|---|")
    fails = 0
    for rec, crs in rows:
        ev = dict(rec.events)
        ff = dict(ev.get("fault_free", {}))
        fails += sum(1 for c in crs if not c.passed)
        same = (ev.get("checksum") is not None
                and ev.get("checksum") == ff.get("checksum"))
        add("| " + " | ".join([
            rec.kernel, rec.engine,
            f"{rec.num_shards or 1}-way",
            f"`{ev.get('spec', '')}`",
            _fmt(ev.get("failures")), _fmt(ev.get("resizes")),
            (f"{_fmt(ev.get('availability'))} ≥ "
             f"{_fmt(ev.get('availability_target'))}"),
            _fmt(ev.get("recovery_ms_total")),
            _fmt(rec.p99_ms), _fmt(ff.get("p99_ms")),
            "bit-exact" if same else "MISMATCH",
            _serving_claim_verdict(crs),
        ]) + " |")
    add("")
    if fails == 0:
        add(f"**{len(rows)} chaos sessions; zero claim violations.** "
            "The paper's verdict is failure-invariant: a shard death "
            "re-dispatches onto the same §6-routed, Eq. 23/24-bounded "
            "execution, and a mesh resize re-plans the same memory-bound "
            "split — so the elastic runtime changes *when* requests "
            "complete, never *what* they compute, and never the ceiling.")
    else:
        add(f"**{fails} claim violation(s) across {len(rows)} chaos "
            "sessions — see per-kernel serving pages.**")
    add("")
    return lines


def _verdict_section(serving: Sequence[RecordSet],
                     voice: Voice) -> List[str]:
    """The REPORT.md model-scale verdict block (lm serving records).

    One row per (model, engine) session carrying a ``verdict`` payload:
    what fraction of a whole decode step's time and bytes the paper's
    Eq. 23/24 memory-bound ceiling governs, per real model config — the
    kernel-level verdict promoted to model scale.  Per-op breakdowns
    live on the ``<kernel>-serving.md`` pages.
    """
    rows = [(rec, crs) for rs in serving for rec, crs in _check_set(rs)
            if rec.verdict]
    if not rows:
        return []
    lines: List[str] = []
    add = lines.append
    add("## Verdict at model scale")
    add("")
    add(f"Schema-4 lm sessions (`{voice.serve} "
        "--workload lm --config <name>`): one full decode step per "
        "real model config, every layer op (qkv/o projections, the "
        "flash-decode cache scan, MLP/MoE experts, SSM mixer, norms, "
        "LM head) classified memory- vs compute-bound by the "
        "dispatcher's Eq. 2/4 Advice. The *mem-bound time* column is "
        "the fraction of the step's roofline time governed by the "
        "Eq. 23/24 ceiling — where that fraction is ~1.0, a matrix "
        "engine cannot buy the model more than the paper's ≤1.33x, "
        "end to end. The `model_verdict` claim re-derives every row "
        "and reconciles the per-op times against the measured mean "
        "decode step.")
    add("")
    add("| model | engine | batch | cache len | step ms | prefill ms | "
        "decode ms | mem-bound time | mem-bound bytes | ops (bound/"
        "total) | claims |")
    add("|---|---|---|---|---|---|---|---|---|---|---|")
    for rec, crs in rows:
        v = dict(rec.verdict)
        ops = list(v.get("ops", []))
        bound = sum(1 for o in ops if o.get("memory_bound"))
        phases = dict(rec.phases or {})
        add("| " + " | ".join([
            str(rec.model or "—"), rec.engine,
            _fmt(v.get("batch")), _fmt(v.get("cache_len")),
            _fmt(v.get("step_time_ms")), _fmt(phases.get("prefill_ms")),
            _fmt(phases.get("decode_ms")),
            _fmt(v.get("memory_bound_time_frac")),
            _fmt(v.get("memory_bound_bytes_frac")),
            f"{bound}/{len(ops)}",
            _serving_claim_verdict(
                [c for c in crs if c.claim == "model_verdict"]),
        ]) + " |")
    add("")
    models = sorted({str(rec.model) for rec, _ in rows})
    fully = sorted({str(rec.model) for rec, _ in rows
                    if float(dict(rec.verdict).get(
                        "memory_bound_time_frac", 0.0)) >= 0.999})
    if fully == models:
        add(f"**{len(models)} model config(s) "
            f"({', '.join(models)}): the memory-bound ceiling governs "
            "≥99.9% of every decode step.** The paper's per-kernel "
            "verdict holds at model scale — batched single-token decode "
            "is GEMV-shaped throughout, so the vector engine serves the "
            "whole step and tensor cores have nothing left to win.")
    else:
        partial = [m for m in models if m not in fully]
        add(f"**{len(models)} model config(s); {', '.join(partial)} "
            "have compute-bound op time — see per-op tables on the "
            "serving pages.**")
    add("")
    return lines


def _online_section(serving: Sequence[RecordSet],
                    voice: Voice) -> List[str]:
    """The REPORT.md online-tuning block (records with ``tuning``).

    One row per ``serve --online-tune`` session: how many bandit keys
    the session tuned, how many decisions it made, the total regret
    against the running best (the price of exploration, in µs of batch
    compute), the router's width trajectory when ``--slo-route`` was
    on, and the session's p99 against the statically-tuned baseline of
    the same (kernel, workload, size, dtype) config — adaptivity must
    pay for itself at the tail.  The ``online_ceiling`` claim replays
    every decision and holds the Eq. 23/24 line: a bandit may tune
    tiles, never route memory-bound work onto the matrix engine.
    """
    rows = [(rec, crs) for rs in serving for rec, crs in _check_set(rs)
            if rec.tuning]
    if not rows:
        return []
    static_p99: Dict[Tuple, float] = {}
    for rs in serving:
        for rec in rs.records:
            if not rec.tuning:
                key = (rec.kernel, rec.workload, rec.size, rec.dtype,
                       rec.engine)
                static_p99[key] = rec.p99_ms
    lines: List[str] = []
    add = lines.append
    add("## Online tuning")
    add("")
    add(f"Sessions from `{voice.serve} --online-tune "
        "[--slo-route]`: a budgeted UCB bandit over each family's "
        "declared `tile_space` re-tunes tile shapes from measured batch "
        "compute inside the virtual clock, warm-started from the "
        "committed `tuned.json`; with `--slo-route`, shard width and "
        "exploration follow queue depth and SLO headroom instead of "
        "the roofline alone. The `online_ceiling` claim replays every "
        "recorded decision byte-identically and re-checks Eq. 23/24 on "
        "each one — an adaptive router never \"discovers\" a "
        "matrix-engine win the ceiling forbids.")
    add("")
    add("| kernel | workload | engine | keys | decisions | regret µs | "
        "router widths | p99 ms | static p99 ms | goodput /s | claims |")
    add("|---|---|---|---|---|---|---|---|---|---|---|")
    fails = 0
    for rec, crs in rows:
        t = dict(rec.tuning)
        fails += sum(1 for c in crs if not c.passed)
        widths = [int(d.get("width", 1)) for d in
                  dict(t.get("router") or {}).get("decisions", [])]
        trajectory = "—"
        if widths:
            hops = [widths[0]]
            for w in widths[1:]:
                if w != hops[-1]:
                    hops.append(w)
            trajectory = "→".join(str(w) for w in hops)
        baseline = static_p99.get((rec.kernel, rec.workload, rec.size,
                                   rec.dtype, rec.engine))
        add("| " + " | ".join([
            rec.kernel, rec.workload, rec.engine,
            str(len(dict(t.get("keys", {})))),
            _fmt(t.get("decisions")), _fmt(t.get("regret_us_total")),
            trajectory, _fmt(rec.p99_ms), _fmt(baseline),
            _fmt(rec.goodput_rps), _serving_claim_verdict(crs),
        ]) + " |")
    add("")
    if fails == 0:
        add(f"**{len(rows)} online-tuned sessions; zero claim "
            "violations.** Adaptivity changes tiles and shard width, "
            "never the verdict: every bandit key and every router "
            "decision stayed on the engine Eq. 23/24 prescribes, and "
            "the recorded decision sequences replay exactly.")
    else:
        add(f"**{fails} claim violation(s) across {len(rows)} "
            "online-tuned sessions — see per-kernel serving pages.**")
    add("")
    return lines


def _observability_section(recsets: Sequence[RecordSet],
                           voice: Voice) -> List[str]:
    """The REPORT.md observability block (schema-7 ``trace`` records).

    Two tables from the :mod:`repro.obs` tracer's independent account
    of every measurement.  The bench table aggregates the roofline
    gauge per (kernel, engine): achieved bandwidth against the
    platform's ``mem_bw`` (the live Eq. 4 gauge) and achieved FLOP/s
    against the Eq. 3 attainable ceiling — on this container the
    absolute fractions are tiny (XLA-CPU oracle timings stand in for
    accelerator walls), so the column that matters is *reconciled*:
    every gauge re-derives from its own record's traffic, time, and
    hardware model, claim-checked.  The serving table reconciles the
    virtual-clock span counts against each session log.
    """
    bench_rows = [(rs, rec, crs) for rs in recsets
                  if rs.kind == "bench"
                  for rec, crs in _check_set(rs) if rec.trace]
    serving_rows = [(rs, rec, crs) for rs in recsets
                    if rs.kind == "serving"
                    for rec, crs in _check_set(rs) if rec.trace]
    if not bench_rows and not serving_rows:
        return []
    lines: List[str] = []
    add = lines.append
    add("## Observability")
    add("")
    add(f"Every record carries the `{voice.pkg}.obs` tracer's independent "
        "account of its own measurement (`trace` block, schema 7): "
        "`time_fn` emits one wall-clock span per timing iteration — "
        "the span *is* the sample — and the serving loop emits its "
        "admission/queue/batch timeline on the replayable virtual "
        "clock. The `trace_reconciliation` claim proves the two "
        "accounts agree within serialization rounding; full span "
        "timelines export as Chrome-trace JSON via `python -m "
        f"{voice.sweep_trace}` / `serve --trace-out "
        f"out.json` and validate with `python -m {voice.pkg}.obs.trace`.")
    add("")
    if bench_rows:
        add("| kernel | engine | points | spans/point | achieved GB/s "
            "(median) | % of B_mem (Eq. 4) | % of ceiling (Eq. 3) | "
            "trace claims |")
        add("|---|---|---|---|---|---|---|---|")
        by_ke: Dict[Tuple[str, str], List] = {}
        for rs, rec, crs in bench_rows:
            label = _set_label(rs)
            by_ke.setdefault((label, rec.engine), []).append((rec, crs))
        for (label, engine), rows in sorted(by_ke.items()):
            roofs = [dict(dict(rec.trace).get("roofline") or {})
                     for rec, _ in rows]
            spans = sorted({int(dict(rec.trace).get("spans", 0))
                            for rec, _ in rows})
            trace_claims = [c for _, crs in rows for c in crs
                            if c.claim == "trace_reconciliation"]
            med = (lambda k: statistics.median(
                float(r.get(k, 0.0)) for r in roofs))
            add("| " + " | ".join([
                label, engine, str(len(rows)),
                "/".join(str(s) for s in spans),
                _fmt(med("achieved_gbs")),
                _fmt(med("pct_of_bound")),
                _fmt(med("pct_of_ceiling")),
                _claim_cell(trace_claims, "trace_reconciliation"),
            ]) + " |")
        add("")
    if serving_rows:
        add("| session | engine | batch spans / launches | queue spans "
            "/ completed | span compute ms | log compute ms | chaos "
            "marks | trace claims |")
        add("|---|---|---|---|---|---|---|---|")
        for rs, rec, crs in serving_rows:
            tr = dict(rec.trace)
            chaos = ("—" if "chaos_instants" not in tr else
                     f"{_fmt(tr.get('chaos_instants'))} instants, "
                     f"{_fmt(tr.get('redispatch_spans'))} redispatch")
            trace_claims = [c for c in crs
                            if c.claim == "trace_reconciliation"]
            add("| " + " | ".join([
                _set_label(rs), rec.engine,
                f"{_fmt(tr.get('batch_spans'))} / {rec.batches}",
                f"{_fmt(tr.get('queue_spans'))} / {rec.completed}",
                _fmt(tr.get("span_compute_ms")),
                _fmt(tr.get("log_compute_ms")),
                chaos,
                _claim_cell(trace_claims, "trace_reconciliation"),
            ]) + " |")
        add("")
    bad = sum(1 for _, _, crs in bench_rows + serving_rows for c in crs
              if c.claim == "trace_reconciliation" and not c.passed)
    n = len(bench_rows) + len(serving_rows)
    if bad == 0:
        add(f"**{n} traced records; zero trace-reconciliation "
            "violations.** The timeline the tracer narrates is the "
            "measurement the records publish — span medians equal the "
            "recorded walls, the roofline gauge re-derives from each "
            "record's own numbers, and every serving span count matches "
            "its session log.")
    else:
        add(f"**{bad} trace-reconciliation violation(s) across {n} "
            "traced records — see per-kernel pages.**")
    add("")
    return lines


def _engine_pairs(serving: Sequence[RecordSet]):
    """(key, (vector record, matrix record)) pairs for the same session
    config served under both forced engines, sorted by key.  The mesh
    width is part of the key so a sharded session never pairs against
    the single-device run of the other engine.  Online-tuned sessions
    are excluded — their engine comes from ``auto``, so they would
    shadow the forced-vector leg of the same config."""
    by_key: Dict[Tuple, Dict[str, ServingRecord]] = {}
    for rs in serving:
        for rec in rs.records:
            if rec.tuning:
                continue
            key = (rec.kernel, rec.workload, rec.size, rec.dtype,
                   rec.num_shards or 1)
            by_key.setdefault(key, {})[rec.engine] = rec
    return [(key, (engines["vector"], engines["matrix"]))
            for key, engines in sorted(by_key.items())
            if "vector" in engines and "matrix" in engines]


def render_serving_page(rs: RecordSet) -> str:
    """Render one ``docs/benchmarks/<kernel>-serving.md`` session page."""
    voice = _voice([rs])
    lines: List[str] = []
    add = lines.append
    add(f"# `{rs.kernel}` — serving evidence")
    add("")
    add(f"Source: `{os.path.basename(rs.path)}` (schema {rs.schema}, "
        f"serving records). Each row is one seeded session through the "
        f"continuous-batching scheduler. Regenerate with `{voice.regen}`; "
        f"produce new sessions with `{voice.serve}`.")
    add("")
    add("| workload | engine | auto | rate /s | dur s | size | dtype | "
        "offered | completed | batches | mean batch | p50 ms | p95 ms | "
        "p99 ms | queue p50 | compute p50 | goodput /s | SLO ms | "
        "attain | claims |")
    add("|" + "---|" * 20)
    checked = _check_set(rs)
    for rec, crs in checked:
        add("| " + " | ".join([
            rec.workload, rec.engine, rec.engine_auto,
            _fmt(rec.rate_rps), _fmt(rec.duration_s), str(rec.size),
            rec.dtype, str(rec.offered), str(rec.completed),
            _fmt(rec.batches), _fmt(rec.mean_batch), _fmt(rec.p50_ms),
            _fmt(rec.p95_ms), _fmt(rec.p99_ms), _fmt(rec.queue_p50_ms),
            _fmt(rec.compute_p50_ms), _fmt(rec.goodput_rps),
            _fmt(rec.slo_ms), _fmt(rec.slo_attainment),
            _serving_claim_verdict(crs),
        ]) + " |")
    add("")
    for rec, _ in checked:
        if not rec.verdict:
            continue
        v = dict(rec.verdict)
        phases = dict(rec.phases or {})
        add(f"## Model-scale verdict — `{rec.model}` "
            f"({rec.engine} engine)")
        add("")
        add(f"One decode step at batch {_fmt(v.get('batch'))} against a "
            f"{_fmt(v.get('cache_len'))}-token cache "
            f"({_fmt(v.get('dtype_bytes'))}-byte weights): measured "
            f"mean step {_fmt(v.get('step_time_ms'))} ms "
            f"(session split: prefill {_fmt(phases.get('prefill_ms'))} "
            f"ms, decode {_fmt(phases.get('decode_ms'))} ms over "
            f"{_fmt(phases.get('decode_steps'))} steps). Per-op time "
            "distributes the measured step by the modeled roofline "
            "fractions; the `model_verdict` claim re-derives every "
            "row.")
        add("")
        add("| op | flops | bytes | I (Eq. 2) | memory-bound | engine | "
            "MXU ceiling | time frac | time ms | bytes frac |")
        add("|---|---|---|---|---|---|---|---|---|---|")
        for o in v.get("ops", []):
            add("| " + " | ".join([
                str(o.get("name")), _fmt(o.get("flops"), 3),
                _fmt(o.get("bytes"), 3), _fmt(o.get("intensity")),
                _fmt(bool(o.get("memory_bound"))),
                str(o.get("engine")),
                f"{_fmt(o.get('mxu_ceiling'))}x",
                _fmt(o.get("time_frac")), _fmt(o.get("time_ms")),
                _fmt(o.get("bytes_frac")),
            ]) + " |")
        add("")
    for rec, _ in checked:
        if not rec.tuning:
            continue
        t = dict(rec.tuning)
        router = dict(t.get("router") or {})
        add(f"## Online tuning — {rec.engine} engine, budget "
            f"{_fmt(t.get('budget'))}")
        add("")
        add(f"{_fmt(t.get('decisions'))} bandit decisions, total regret "
            f"{_fmt(t.get('regret_us_total'))} µs vs the running best. "
            "Arm 0 is the warm start (the committed `tuned.json` entry "
            "when one matches the exact 5-tuple key, the static default "
            "otherwise); `committed µs` is that entry's "
            f"{voice.online_clock}, recorded for provenance, never "
            "compared. The "
            "`online_ceiling` claim replays every event below.")
        add("")
        add("| key | arms | pulls | warm | committed µs | warm-obs µs | "
            "best µs | winner arm | winner tiles |")
        add("|---|---|---|---|---|---|---|---|---|")
        for key, kd in sorted(dict(t.get("keys", {})).items()):
            kd = dict(kd)
            arms = [dict(a) for a in kd.get("arms", [])]
            winner = kd.get("winner")
            tiles = "—"
            if winner is not None and 0 <= int(winner) < len(arms):
                tiles = ", ".join(f"{k}={v}" for k, v in
                                  sorted(arms[int(winner)].items())) \
                    or "—"
            add("| " + " | ".join([
                f"`{key}`", str(len(arms)),
                _fmt(len(kd.get("events", []))),
                str(kd.get("warm_source", "—")),
                _fmt(kd.get("committed_us")), _fmt(kd.get("warm_us")),
                _fmt(kd.get("best_us")), _fmt(winner), tiles,
            ]) + " |")
        add("")
        if router.get("decisions"):
            add(f"### Router decisions (SLO {_fmt(router.get('slo_ms'))} "
                f"ms, max width {_fmt(router.get('max_width'))}, band "
                f"[{_fmt(router.get('shrink_depth'))}, "
                f"{_fmt(router.get('grow_depth'))}])")
            add("")
            add("| clock s | engine | depth | headroom ms | width | "
                "explore | reason |")
            add("|---|---|---|---|---|---|---|")
            for d in router["decisions"]:
                d = dict(d)
                add("| " + " | ".join([
                    _fmt(d.get("clock_s")), str(d.get("engine")),
                    _fmt(d.get("queue_depth")),
                    _fmt(d.get("headroom_ms")), _fmt(d.get("width")),
                    _fmt(bool(d.get("explore"))),
                    str(d.get("reason")),
                ]) + " |")
            add("")
    for rec, _ in checked:
        if not rec.events:
            continue
        ev = dict(rec.events)
        ff = dict(ev.get("fault_free", {}))
        add(f"## Chaos event log — {rec.engine} engine, "
            f"`{ev.get('spec', '')}`")
        add("")
        add(f"Availability {_fmt(ev.get('availability'))} (target "
            f"{_fmt(ev.get('availability_target'))}); chaos checksum "
            f"{'==' if ev.get('checksum') == ff.get('checksum') else '!='}"
            f" fault-free checksum; fault-free leg completed "
            f"{_fmt(ff.get('completed'))}/{_fmt(ff.get('offered'))} at "
            f"p99 {_fmt(ff.get('p99_ms'))} ms; total recovery "
            f"{_fmt(ev.get('recovery_ms_total'))} ms. Virtual-clock "
            "times; `skipped` events fell past the end of traffic.")
        add("")
        add("| at s | kind | detail |")
        add("|---|---|---|")
        for entry in ev.get("log", []):
            kind = str(entry.get("kind", "?"))
            if entry.get("skipped"):
                detail = "skipped (after last batch)"
            elif kind == "fail":
                detail = (f"shard {_fmt(entry.get('shard'))}/"
                          f"{_fmt(entry.get('width'))} died in batch "
                          f"{_fmt(entry.get('batch_id'))}; re-dispatch "
                          f"{_fmt(entry.get('recovery_ms'))} ms, "
                          f"bit-exact="
                          f"{_fmt(bool(entry.get('redispatch_exact')))}")
            else:
                detail = (f"{_fmt(entry.get('from'))}→"
                          f"{_fmt(entry.get('to'))} shards "
                          f"({entry.get('reason', '—')}), dp_rescale "
                          f"{_fmt(entry.get('dp_rescale'))}, re-shard "
                          f"bit-exact="
                          f"{_fmt(bool(entry.get('reshard_exact')))}")
            add(f"| {_fmt(entry.get('at_s'))} | {kind} | {detail} |")
        add("")
    fails = [(rec, c) for rec, crs in checked
             for c in crs if not c.passed]
    if fails:
        add("## Violations")
        add("")
        for rec, c in fails:
            add(f"- `{'/'.join(map(str, rec.point))}` **{c.claim}**: "
                f"{c.detail}")
        add("")
    return "\n".join(lines)


def render_kernel_page(rs: RecordSet) -> str:
    """Render one ``docs/benchmarks/<kernel>.md`` sweep-evidence page.

    Mesh sweeps (schema-5 sets with a ``mesh_shape`` environment) get the
    same table plus the shard columns: split kind/halo, the
    aggregate-vs-unsharded traffic overhead, and the per-shard memory
    floor the shard claims were checked against; points measured on
    ranks (``mesh_exec``) add the mesh wall, collective and skew columns.
    """
    voice = _voice([rs])
    hw = hw_for(rs)
    mesh = rs.mesh_devices
    real = any(rec.mesh_exec for rec in rs.records)
    lines: List[str] = []
    add = lines.append
    add(f"# `{rs.kernel}` — benchmark evidence" if mesh == 1 else
        f"# `{rs.kernel}` — {mesh}-way mesh evidence")
    add("")
    add(f"Source: `{os.path.basename(rs.path)}` (schema {rs.schema}); "
        f"verified against the `{hw.name}` model "
        f"(B_vec = {_fmt(machine_balance(hw, 'vector'))} flop/byte, "
        f"α = {_fmt(hw.alpha)}). Regenerate with `{voice.regen}`.")
    if mesh > 1:
        add("")
        where = ("data-axis mesh" if voice is REFERENCE_VOICE
                 else "split")
        add(f"Every point executed shard by shard under a {mesh}-way "
            f"{where} (`{voice.pkg}.sharding`); `max err` certifies the "
            "*sharded* result against the oracle, so halo exchange and "
            "head/row splits are correctness-gated evidence. Produce new "
            f"points with `{voice.sweep} --mesh {mesh}`.")
        if real:
            add("")
            if voice is REFERENCE_VOICE:
                add("Points carry schema-6 `mesh_exec` evidence (`--real`): "
                    f"the plan ran as one `shard_map` program over {mesh} "
                    "real host devices. *mesh wall µs* is the measured "
                    "program wall, *coll µs* isolates the `ppermute` halo "
                    "ring (0 when the plan moves no wire bytes), and "
                    "*skew* divides the measured wall by the virtual "
                    "max-over-shards clock.")
            else:
                add("Points carry schema-6 `mesh_exec` evidence (`--real`): "
                    f"the plan ran on {mesh} ranks at once. *mesh wall µs* "
                    "is the measured step wall, *coll µs* the halo "
                    "exchange alone (0 when the plan moves no wire bytes), "
                    "and *skew* divides the measured wall by the virtual "
                    "slowest-shard clock.")
    add("")
    shard_cols = ("| kind | halo | agg/total | shard floor µs "
                  if mesh > 1 else "")
    real_cols = ("| mesh wall µs | coll µs | skew " if real else "")
    add(f"| engine | size | dtype | {voice.time_label} | IQR µs | iters | "
        f"{voice.pred_label} | I (Eq. 2) | memory-bound | auto | MXU "
        "ceiling | Eq. 23/24 bound | max err | tile config | tuned Δ "
        f"{shard_cols}{real_cols}| claims |")
    add("|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"
        + ("---|" * 4 if mesh > 1 else "")
        + ("---|" * 3 if real else "") + "---|")
    checked = _check_set(rs)
    for rec, crs in checked:
        failed = [c.claim for c in crs if not c.passed]
        verdict = "✅" if not failed else "❌ " + ",".join(failed)
        cells = [
            rec.engine, str(rec.size), rec.dtype,
            _fmt(rec.timed_us, 6), _fmt(rec.iqr_us),
            _fmt(rec.iters), _fmt(rec.pred_us),
            _fmt(rec.intensity), _fmt(rec.memory_bound),
            rec.engine_auto, f"{_fmt(rec.mxu_ceiling)}x",
            f"{_fmt(ceiling_bound(rec.intensity, hw))}x",
            _fmt(rec.max_err, 3), _tile_cell(rec),
            _tuned_delta_cell(rec),
        ]
        if mesh > 1:
            spec = dict(rec.shard_spec or {})
            total = float(spec.get("total_bytes", 0.0))
            agg = float(spec.get("agg_bytes", 0.0))
            cells += [
                str(spec.get("kind", "—")), str(spec.get("halo", "—")),
                f"{_fmt(agg / total)}x" if total else "—",
                _fmt(_shard_floor(spec)),
            ]
        if real:
            me = dict(rec.mesh_exec or {})
            cells += [
                _fmt(me.get("mesh_wall_us")),
                _fmt(me.get("collective_us")),
                (f"{_fmt(me.get('skew'))}x"
                 if me.get("skew") is not None else "—"),
            ]
        add("| " + " | ".join(cells + [verdict]) + " |")
    add("")
    fails = [(rec, c) for rec, crs in checked
             for c in crs if not c.passed]
    if fails:
        add("## Violations")
        add("")
        for rec, c in fails:
            add(f"- `{'/'.join(map(str, rec.point))}` **{c.claim}**: "
                f"{c.detail}")
        add("")
    return "\n".join(lines)


def write_report(runs_dir: str = "build/runs_torch",
                 report_path: str = os.path.join("build", "runs_torch",
                                                 "REPORT.md"),
                 docs_dir: str = os.path.join("build", "runs_torch", "docs",
                                              "benchmarks"),
                 ) -> List[str]:
    """Regenerate REPORT.md + per-kernel pages from *runs_dir* records.

    The single entry point behind ``python -m repro_torch.bench report``:
    load -> verify (Eq. 4/17/23/24, §6) -> render deterministically.
    Returns the list of paths written.  *docs_dir* holds generated pages
    only: pages of record sets no longer in *runs_dir* are deleted, which
    is why the defaults lie under ``build/`` and never name the
    repository's own ``REPORT.md`` or ``docs/benchmarks/``.
    """
    from .records import load_dir

    recsets = load_dir(runs_dir)
    written = []
    parent = os.path.dirname(report_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(report_path, "w") as f:
        f.write(render_report(recsets))
    written.append(report_path)
    os.makedirs(docs_dir, exist_ok=True)
    current = {page_name(rs) for rs in recsets}
    for name in sorted(os.listdir(docs_dir)):
        # docs_dir holds only generated pages: drop orphans of removed
        # kernels so the published evidence always matches the records
        if name.endswith(".md") and name not in current:
            os.remove(os.path.join(docs_dir, name))
    for rs in recsets:
        page = os.path.join(docs_dir, page_name(rs))
        render = (render_serving_page if rs.kind == "serving"
                  else render_kernel_page)
        with open(page, "w") as f:
            f.write(render(rs))
        written.append(page)
    return written
