"""Per-record claim verification: measurements vs. the paper's theory.

Joins every :class:`~repro_torch.report.records.BenchRecord` back to the
analytic layer (``repro_torch.core.advisor`` / ``bounds`` / ``balance``)
and checks the paper's claims record by record, with the reference
package's rules and detail strings:

* **ceiling** (Eq. 23/24) -- the recorded matrix-engine speedup ceiling
  never exceeds min(2 - 2/(1+alpha), 1 + I/B), and never drops below the
  fully-overlapped floor of 1.0 (Eq. 17).
* **routing** (§6) -- memory-bound records route ``engine='auto'`` to the
  vector engine; compute-bound records to the matrix engine.
* **accuracy** (§5 methodology) -- both engine variants reproduce the
  oracle within a per-dtype tolerance.
* **boundedness** (Eq. 4) -- the recorded memory-bound flag matches a
  fresh I < B_vector derivation from the recorded intensity.

Serving records (sessions under traffic) get their own claim set
(:data:`SERVING_CLAIMS`): the Eq. 23/24 **ceiling**, §6 routing and
Eq. 4 boundedness re-derived exactly as above, plus two
internal-consistency claims -- latency percentiles non-negative and
monotone (p50 <= p95 <= p99), and goodput consistent with the
SLO-attainment and completion accounting.  An lm session's model-scale
``verdict`` payload passes **model_verdict** (:data:`MODEL_CLAIMS`): every
per-op row re-derived (Eq. 2 intensity, Eq. 4 boundedness, §6 routing,
Eq. 23/24 ceiling) and the whole step accounted for.

Records carrying the obs ``trace`` block additionally pass
**trace_reconciliation** (:data:`TRACE_CLAIMS`).  For a bench record the
span count equals the timing iterations, the span median equals the
recorded median within rounding (the span *is* the sample), and the
roofline gauge re-derives exactly from the record's own traffic, time
and hardware model.  The recorded median is the engine kernel's
``us_per_call`` where the record has it (the port's sweep) and the
oracle's ``ref_us_per_call`` otherwise (the reference's records).  For a
serving record the virtual-clock batch spans equal the logged launches,
one queue span per completed request, and the summed span compute equals
the log's compute total.

Online-tuned sessions (``serve --online-tune``) carrying a ``tuning``
block pass **online_ceiling** (:data:`ONLINE_CLAIMS`): every bandit key
and router decision held to Eq. 23/24, every arm inside the family's
``tile_space``, the arm sequence replayed byte-identically from the
event log, the regret arithmetic and the router trajectory re-derived.

Two differences from the reference, both so that nothing passes
silently: :func:`hw_for` raises on a hardware model it does not know,
where the reference falls back to the TPU v5e; and records that need
claims the port does not have yet raise ``NotImplementedError`` naming
the ROADMAP item that ports them: the mesh fields ``shard_spec`` /
``mesh_exec`` and sharded sessions (item 13) and chaos sessions carrying
``events`` (the elastic claim, items 13-14).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple, Union

from ..core.advisor import EngineAdvisor
from ..core.balance import machine_balance
from ..core.bounds import tensor_core_upper_bound, workload_upper_bound
from ..core.hw import PLATFORMS, HardwareSpec
from ..core.intensity import KernelTraits
from ..obs.counters import roofline_sample
from .records import BenchRecord, RecordSet, ServingRecord

__all__ = ["CLAIMS", "ClaimResult", "MODEL_CLAIMS", "ONLINE_CLAIMS",
           "SAMPLE_CLOCKS", "SERVING_CLAIMS", "TOLERANCE", "TRACE_CLAIMS",
           "ceiling_bound",
           "check_record", "check_records", "check_serving_record",
           "hw_for", "violations"]

#: Claim identifiers, in report order.
CLAIMS = ("ceiling", "routing", "accuracy", "boundedness")

#: Serving-record claim identifiers, in report order.
SERVING_CLAIMS = ("ceiling", "routing", "boundedness", "percentiles",
                  "goodput")

#: Extra claim for serving sessions that carry a model-scale verdict
#: (lm records with a ``verdict`` payload).
MODEL_CLAIMS = ("model_verdict",)

#: Extra claim for online-tuned sessions (records with a ``tuning``
#: payload): every bandit/router decision re-verified and replayed.
ONLINE_CLAIMS = ("online_ceiling",)

#: Extra claim for records carrying the observability ``trace`` block:
#: the tracer's independent account of the measurement reconciles with
#: the record it rode in on.
TRACE_CLAIMS = ("trace_reconciliation",)

#: Clocks a bench trace block may name for its samples: ``wall`` (host
#: ``perf_counter``: the reference's records and the port's CPU runs)
#: and ``cuda_event`` (CUDA-event pairs: the port's runs on the card).
SAMPLE_CLOCKS = ("wall", "cuda_event")

#: Rounding slack for span-vs-record microsecond comparisons: the
#: reference rounds ``ref_us_per_call`` to 0.1 us and the span medians to
#: 0.001 us, so two exactly equal timings may differ by half of the
#: coarser step (0.05) plus the finer one.
_TRACE_US_SLACK = 0.051

#: Max abs error allowed between an engine variant and its oracle.
#: bfloat16 has an 8-bit mantissa, so elementwise results on O(10)
#: magnitudes legitimately differ by ~2^-4.
TOLERANCE: Dict[str, float] = {"float32": 1e-4, "bfloat16": 0.125}

_EPS = 1e-9

#: ROADMAP items that port the claims this module refuses to skip.
_WAITING = {
    "mesh": "the shard and mesh claims wait for ROADMAP Queue 1 item 13 "
            "(sharding)",
    "elastic": "the elastic_integrity claim of chaos sessions waits for "
               "ROADMAP Queue 1 items 13-14 (sharding, runtime)",
}


@dataclasses.dataclass(frozen=True)
class ClaimResult:
    """Outcome of one claim check against one bench/serving record."""

    claim: str           # one of CLAIMS / SERVING_CLAIMS / ...
    record: Union[BenchRecord, ServingRecord]
    passed: bool
    detail: str          # human-readable evidence string


def hw_for(recset: RecordSet) -> HardwareSpec:
    """Resolve a record set's ``env.hw_model`` to a HardwareSpec.

    Knows the name of every platform in ``PLATFORMS`` (``H100-SXM5`` /
    ``H100-PCIe`` / ``H100-NVL`` among them); raises ``ValueError`` on
    anything else, a missing name included: a wrong spec would move every
    balance and ceiling the claims re-derive.
    """
    name = str(recset.env.get("hw_model", ""))
    for hw in PLATFORMS.values():
        if hw.name == name:
            return hw
    raise ValueError(
        f"{recset.path}: unknown hw_model {name!r}; known: "
        f"{sorted({hw.name for hw in PLATFORMS.values()})}")


def ceiling_bound(intensity: float, hw: HardwareSpec) -> float:
    """The paper's composite matrix-engine ceiling for one kernel.

    min(Eq. 23: 2 - 2/(1+alpha), Eq. 24: 1 + I/B_vector) -- the tightest
    bound any memory-bound record may report.
    """
    b_vec = machine_balance(hw, "vector")
    return min(tensor_core_upper_bound(hw.alpha),
               workload_upper_bound(intensity, b_vec))


def _analytic_checks(rec, hw: HardwareSpec,
                     routing_context: str = "") -> List[ClaimResult]:
    """The ceiling / routing / boundedness checks (Eq. 17/23/24, §6, Eq. 4)
    both record kinds share: bench sweep points and serving sessions
    carry the same analytic join fields, so one implementation verifies
    them and the two kinds can never drift onto different rules."""
    advice = EngineAdvisor(hw).advise(
        KernelTraits(rec.kernel, rec.intensity, 1.0))
    results = []

    bound = ceiling_bound(rec.intensity, hw)
    if rec.memory_bound:
        ceiling_ok = 1.0 - _EPS <= rec.mxu_ceiling <= bound + _EPS
        ceiling_detail = (f"recorded ceiling {rec.mxu_ceiling:.4g}x vs "
                          f"Eq. 23/24 bound {bound:.4g}x")
    else:
        # Compute-bound records escape Eq. 23/24; the ceiling may reach
        # the full engine ratio alpha but no further.
        ceiling_ok = 1.0 - _EPS <= rec.mxu_ceiling <= hw.alpha + _EPS
        ceiling_detail = (f"compute-bound: ceiling {rec.mxu_ceiling:.4g}x "
                          f"vs alpha {hw.alpha:.4g}")
    results.append(ClaimResult("ceiling", rec, ceiling_ok, ceiling_detail))

    routing_ok = rec.engine_auto == advice.engine and (
        not rec.memory_bound or rec.engine_auto == "vector")
    results.append(ClaimResult(
        "routing", rec, routing_ok,
        f"auto={rec.engine_auto} vs advisor={advice.engine} "
        f"(memory_bound={rec.memory_bound}{routing_context})"))

    results.append(ClaimResult(
        "boundedness", rec, rec.memory_bound == advice.memory_bound,
        f"recorded memory_bound={rec.memory_bound} vs derived "
        f"I={rec.intensity:.4g} < B_vec={machine_balance(hw, 'vector'):.4g} "
        f"-> {advice.memory_bound}"))
    return results


def _trace_checks(rec: BenchRecord,
                  hw: HardwareSpec) -> List[ClaimResult]:
    """The TRACE_CLAIMS check for one bench record's trace block.

    ``time_fn`` emits one span per timing iteration carrying the recorded
    sample, so the tolerance is serialization rounding
    (:data:`_TRACE_US_SLACK`).  The roofline gauge must re-derive from the
    record's own traffic bytes, recorded median and hardware model
    through ``roofline_sample``.  The median reconciled is
    :attr:`BenchRecord.timed_us`: the engine's ``us_per_call`` where
    recorded ("engine" in the detail), else ``ref_us_per_call`` ("ref").
    """
    tr = dict(rec.trace or {})
    problems: List[str] = []
    timed = rec.timed_us
    what, field_name = (("ref", "ref_us_per_call")
                        if rec.us_per_call is None
                        else ("engine", "us_per_call"))

    if tr.get("clock") not in SAMPLE_CLOCKS:
        problems.append(f"bench trace on clock {tr.get('clock')!r}")
    spans = int(tr.get("spans", -1))
    if rec.iters is not None and spans != rec.iters:
        problems.append(f"{spans} {what} spans != {rec.iters} timing iters")
    med = float(tr.get("span_median_us", -1.0))
    if abs(med - timed) > _TRACE_US_SLACK:
        problems.append(f"span median {med:.4g} us != {field_name} "
                        f"{timed:.4g} us")

    roof = dict(tr.get("roofline") or {})
    if not roof:
        problems.append("missing roofline gauge")
    else:
        traffic = float(roof.get("traffic_bytes", 0.0))
        work = float(roof.get("work_flops", 0.0))
        meas = float(roof.get("measured_us", -1.0))
        if traffic <= 0.0:
            problems.append(f"roofline traffic {traffic:.4g} B <= 0")
        else:
            if abs(work / traffic - rec.intensity) > \
                    1e-6 * max(rec.intensity, 1.0):
                problems.append(
                    f"roofline W/Q {work / traffic:.4g} != recorded "
                    f"intensity {rec.intensity:.4g}")
            if abs(meas - timed) > 1e-3:
                problems.append(f"roofline measured {meas:.4g} us != "
                                f"{field_name} {timed:.4g} us")
            expect = roofline_sample(
                KernelTraits(rec.kernel, work, traffic), hw, rec.engine,
                rec.dtype, timed)
            for field in ("achieved_gbs", "pct_of_bound",
                          "pct_of_ceiling"):
                got = float(roof.get(field, -1.0))
                want = float(getattr(expect, field))
                if abs(got - want) > 1e-4 + 1e-6 * abs(want):
                    problems.append(f"roofline {field} {got:.6g} != "
                                    f"re-derived {want:.6g}")
    if tr.get("mesh"):
        problems.append("mesh trace block on a non-mesh record")

    detail = (f"{spans} spans, median {med:.4g} us vs {what} "
              f"{timed:.4g} us, roofline re-derived"
              + (f"; problems: {'; '.join(problems[:4])}" if problems
                 else ""))
    return [ClaimResult("trace_reconciliation", rec, not problems, detail)]


def _serving_trace_checks(rec: ServingRecord) -> List[ClaimResult]:
    """The TRACE_CLAIMS check for one serving record's trace block.

    Two independently-kept accounts of the same virtual timeline — the
    tracer's spans (emitted inside the serving loop) and the
    :class:`~repro_torch.serving.scheduler.ServingLog`'s batch tuples --
    must tell the same story: span count == logged launches, one queue
    span per completed request, summed span compute == summed logged
    compute (float-rounding tolerance).  The reference's chaos branch
    (redispatch spans and chaos instants) comes with the elastic session:
    a record with ``events`` raises before it gets here.
    """
    tr = dict(rec.trace or {})
    problems: List[str] = []

    if tr.get("clock") != "virtual":
        problems.append(f"serving trace on clock {tr.get('clock')!r}")
    batch_spans = int(tr.get("batch_spans", -1))
    if batch_spans != rec.batches:
        problems.append(f"{batch_spans} batch spans != {rec.batches} "
                        f"logged batches")
    queue_spans = int(tr.get("queue_spans", -1))
    if queue_spans != rec.completed:
        problems.append(f"{queue_spans} queue spans != {rec.completed} "
                        f"completed requests")
    span_ms = float(tr.get("span_compute_ms", -1.0))
    log_ms = float(tr.get("log_compute_ms", -2.0))
    if abs(span_ms - log_ms) > 0.01:
        problems.append(f"span compute {span_ms:.4g} ms != logged "
                        f"compute {log_ms:.4g} ms")

    detail = (f"{batch_spans} batch + {queue_spans} queue spans, span "
              f"compute {span_ms:.4g} ms vs log {log_ms:.4g} ms"
              + (f"; problems: {'; '.join(problems[:4])}" if problems
                 else ""))
    return [ClaimResult("trace_reconciliation", rec, not problems, detail)]


def _verdict_checks(rec: ServingRecord,
                    hw: HardwareSpec) -> List[ClaimResult]:
    """The MODEL_CLAIMS check for one lm session's verdict payload.

    The verdict is the per-op Eq. 2 classification of one decode step
    at model scale (``repro_torch.models.advisor_map``).  The claim
    re-derives every row and the whole-step accounting:

    * per-op intensity equals flops/bytes, the memory_bound flag
      matches a fresh Eq. 4 test, a memory-bound op routes to the
      vector engine (§6), and its recorded ceiling obeys Eq. 23/24 at
      that op's intensity;
    * the time and byte fractions each sum to 1 (every op of the step
      is accounted for — nothing hidden, nothing double-counted);
    * the per-op times sum to the measured mean decode-step wall time
      within rounding tolerance (the classification covers the whole
      measured step, not a convenient subset);
    * the headline memory-bound fractions equal the sum over
      memory-bound ops.
    """
    v = dict(rec.verdict or {})
    ops = list(v.get("ops", []))
    step_ms = float(v.get("step_time_ms", 0.0))
    b_vec = machine_balance(hw, "vector")
    problems: List[str] = []
    if not ops:
        problems.append("empty ops list")

    tsum = bsum = mb_t = mb_b = t_ms = 0.0
    for op in ops:
        name = str(op.get("name", "?"))
        W, Q = float(op.get("flops", 0.0)), float(op.get("bytes", 0.0))
        intensity = float(op.get("intensity", -1.0))
        mb = bool(op.get("memory_bound"))
        engine = str(op.get("engine", ""))
        ceil = float(op.get("mxu_ceiling", 0.0))
        tf, bf = float(op.get("time_frac", 0.0)), \
            float(op.get("bytes_frac", 0.0))
        if Q <= 0.0:
            problems.append(f"{name}: bytes {Q:.4g} <= 0")
            continue
        derived_i = W / Q
        if abs(intensity - derived_i) > 1e-6 * max(derived_i, 1.0):
            problems.append(f"{name}: intensity {intensity:.4g} != "
                            f"W/Q {derived_i:.4g}")
        if mb != (derived_i < b_vec):
            problems.append(f"{name}: memory_bound={mb} vs Eq. 4 "
                            f"I={derived_i:.4g} < B_vec={b_vec:.4g}")
        if mb and engine != "vector":
            problems.append(f"{name}: memory-bound routed to {engine}")
        bound = (ceiling_bound(derived_i, hw) if mb else hw.alpha)
        if not (1.0 - _EPS <= ceil <= bound + _EPS):
            problems.append(f"{name}: ceiling {ceil:.4g}x outside "
                            f"[1, {bound:.4g}]")
        if not (0.0 <= tf <= 1.0 + _EPS and 0.0 <= bf <= 1.0 + _EPS):
            problems.append(f"{name}: fraction outside [0, 1]")
        tsum += tf
        bsum += bf
        t_ms += float(op.get("time_ms", 0.0))
        if mb:
            mb_t += tf
            mb_b += bf

    if ops:
        if abs(tsum - 1.0) > 1e-4:
            problems.append(f"time fractions sum to {tsum:.6g} != 1")
        if abs(bsum - 1.0) > 1e-4:
            problems.append(f"byte fractions sum to {bsum:.6g} != 1")
        # per-op time_ms rows are rounded independently at record time
        if abs(t_ms - step_ms) > 1e-3 * max(step_ms, 1.0) + 1e-3 * len(ops):
            problems.append(f"per-op times sum to {t_ms:.4g} ms vs "
                            f"measured step {step_ms:.4g} ms")
        head_t = float(v.get("memory_bound_time_frac", -1.0))
        head_b = float(v.get("memory_bound_bytes_frac", -1.0))
        if abs(head_t - mb_t) > 1e-4 or abs(head_b - mb_b) > 1e-4:
            problems.append(f"headline fractions ({head_t:.4g}, "
                            f"{head_b:.4g}) != per-op sums "
                            f"({mb_t:.4g}, {mb_b:.4g})")

    detail = (f"{len(ops)} ops, memory-bound time frac {mb_t:.4g}, "
              f"step {step_ms:.4g} ms"
              + (f"; problems: {'; '.join(problems[:4])}" if problems
                 else ""))
    return [ClaimResult("model_verdict", rec, not problems, detail)]


def _online_checks(rec: ServingRecord,
                   hw: HardwareSpec) -> List[ClaimResult]:
    """The ONLINE_CLAIMS check for one session's tuning payload.

    The contract of :mod:`repro_torch.tuning.online` and
    :mod:`repro_torch.serving.router`, verified from the record alone:

    * **ceiling** — every bandit key's engine obeys §6/Eq. 23/24 for
      the record's kernel: memory-bound work (Eq. 4 at the recorded
      intensity, which Eq. 2 keeps invariant under the data split at
      every shard width) may only ever tune *vector*-engine tiles, and
      the same holds for every router decision's engine — an adaptive
      control plane can never "discover" a matrix-engine win the
      ceiling forbids;
    * **arms** — every arm is a point of the family's declared
      ``tile_space`` (an online tuner cannot smuggle undeclared
      launch kwargs);
    * **replay** — the recorded arm sequence replays byte-identically
      through :func:`repro_torch.tuning.online.replay` from the event log
      (same deterministic policy, same rounded observations);
    * **regret** — per-event ``regret_us`` equals the observation
      minus the running minimum (hence ``>= 0``), and the headline
      ``decisions`` / ``regret_us_total`` match the event log;
    * **router** — when the decision log is present, widths stay in
      ``[1, max_width]`` and the whole width/explore sequence replays
      exactly through the recorded policy knobs.
    """
    from ..tuning.online import replay
    t = dict(rec.tuning or {})
    problems: List[str] = []
    advice = EngineAdvisor(hw).advise(
        KernelTraits(rec.kernel, rec.intensity, 1.0))

    if t.get("mode") != "online":
        problems.append(f"tuning mode {t.get('mode')!r} != 'online'")
    budget = int(t.get("budget", 0))
    if budget < 1:
        problems.append(f"bad budget {t.get('budget')!r}")
    bonus = float(t.get("bonus", 1.0))
    keys = dict(t.get("keys", {}))
    total_events = regret_sum = 0.0

    for key, kd in sorted(keys.items()):
        kd = dict(kd)
        composed = "|".join((str(kd.get("kernel")), str(kd.get("engine")),
                             str(kd.get("dtype")),
                             str(kd.get("shard_shape"))))
        if composed != key:
            problems.append(f"{key}: fields compose to {composed!r}")
        engine = str(kd.get("engine"))
        if engine not in ("vector", "matrix"):
            problems.append(f"{key}: unknown engine {engine!r}")
        if kd.get("kernel") == rec.kernel and advice.memory_bound \
                and engine != "vector":
            problems.append(
                f"{key}: memory-bound kernel tuned on the {engine} "
                f"engine — Eq. 23/24 forbids the win")
        arms = [dict(a) for a in kd.get("arms", [])]
        events = [dict(e) for e in kd.get("events", [])]
        if not arms:
            problems.append(f"{key}: no arms")
            continue
        try:
            from ..kernels import registry
            op = registry.get(str(kd.get("kernel")))
        except KeyError:
            op = None
        if op is not None:
            space = {k: {int(x) for x in v}
                     for k, v in dict(op.tile_space).items()}
            for i, arm in enumerate(arms):
                bad = [p for p, v in arm.items()
                       if p not in space or int(v) not in space[p]]
                if bad:
                    problems.append(f"{key}: arm {i} outside the "
                                    f"declared tile_space ({bad})")
        best = None
        for i, ev in enumerate(events):
            obs = float(ev.get("observed_us", -1.0))
            reg = float(ev.get("regret_us", -1.0))
            arm = int(ev.get("arm", -1))
            if not 0 <= arm < len(arms):
                problems.append(f"{key}: event {i} arm {arm} out of "
                                f"range")
                continue
            if obs < 0.0:
                problems.append(f"{key}: event {i} observed "
                                f"{obs:.4g} us < 0")
            best = obs if best is None else min(best, obs)
            want = round(obs - best, 3)
            if abs(reg - want) > 1e-9:
                problems.append(f"{key}: event {i} regret {reg:.4g} != "
                                f"observed - running min {want:.4g}")
            regret_sum += reg
        total_events += len(events)
        try:
            replayed = replay(len(arms), budget, events, bonus=bonus)
        except (KeyError, ValueError) as exc:
            problems.append(f"{key}: replay failed ({exc})")
        else:
            recorded = [int(e["arm"]) for e in events]
            if recorded != replayed:
                problems.append(f"{key}: arm sequence {recorded} does "
                                f"not replay ({replayed})")
        if events and kd.get("best_us") is not None and best is not None \
                and abs(float(kd["best_us"]) - best) > 1e-9:
            problems.append(f"{key}: best_us {kd['best_us']!r} != min "
                            f"observed {best:.4g}")

    if int(t.get("decisions", -1)) != int(total_events):
        problems.append(f"decisions {t.get('decisions')!r} != "
                        f"{int(total_events)} logged events")
    if abs(float(t.get("regret_us_total", -1.0))
           - round(regret_sum, 3)) > 1e-6:
        problems.append(f"regret_us_total {t.get('regret_us_total')!r} "
                        f"!= event sum {round(regret_sum, 3):.4g}")

    router = dict(t.get("router") or {})
    if router:
        max_width = int(router.get("max_width", 0))
        grow = int(router.get("grow_depth", 0))
        shrink = int(router.get("shrink_depth", -1))
        slo_ms = float(router.get("slo_ms", 0.0))
        p_frac = float(router.get("pressure_frac", 0.0))
        e_frac = float(router.get("explore_frac", 0.0))
        if not (max_width >= 1 and 0 <= shrink < grow and slo_ms > 0):
            problems.append(f"bad router knobs (max_width={max_width}, "
                            f"band=[{shrink}, {grow}], slo={slo_ms})")
        width = 1
        for i, d in enumerate(router.get("decisions", [])):
            d = dict(d)
            depth = int(d.get("queue_depth", -1))
            head = float(d.get("headroom_ms", 0.0))
            engine = str(d.get("engine"))
            if d.get("kernel", rec.kernel) == rec.kernel and \
                    advice.memory_bound and engine != "vector":
                problems.append(f"decision {i}: memory-bound batch "
                                f"routed to {engine}")
            want, reason = width, "hold"
            if depth >= grow and head < slo_ms * p_frac \
                    and width < max_width:
                want, reason = min(max_width, width * 2), "grow"
            elif depth <= shrink and width > 1:
                want, reason = max(1, width // 2), "shrink"
            width = want
            explore = depth < grow and head >= slo_ms * e_frac
            if int(d.get("width", -1)) != want or \
                    str(d.get("reason")) != reason or \
                    bool(d.get("explore")) != explore:
                problems.append(
                    f"decision {i}: recorded (width={d.get('width')}, "
                    f"{d.get('reason')}, explore={d.get('explore')}) "
                    f"!= replayed ({want}, {reason}, explore={explore})")
            if not 1 <= int(d.get("width", 0)) <= max_width:
                problems.append(f"decision {i}: width "
                                f"{d.get('width')!r} outside "
                                f"[1, {max_width}]")

    detail = (f"{len(keys)} bandit keys, {int(total_events)} decisions "
              f"replayed, total regret {round(regret_sum, 3):.4g} us, "
              f"router decisions {len(router.get('decisions', []))}"
              + (f"; problems: {'; '.join(problems[:4])}" if problems
                 else ""))
    return [ClaimResult("online_ceiling", rec, not problems, detail)]


def check_record(rec: BenchRecord,
                 hw: HardwareSpec) -> Tuple[ClaimResult, ...]:
    """Verify the paper's claims (Eq. 4, Eq. 17/23/24, §6) for one record.

    One :class:`ClaimResult` per entry in :data:`CLAIMS`, in order, plus
    :data:`TRACE_CLAIMS` where the record carries a ``trace`` block,
    re-deriving the advisor's decision from the recorded intensity so a
    stale or hand-edited record cannot pass.  A mesh record
    (``shard_spec`` or ``mesh_exec``) raises ``NotImplementedError``.
    """
    if rec.shard_spec or rec.mesh_exec:
        raise NotImplementedError(
            f"{rec.kernel}/{rec.engine}/{rec.size}: {_WAITING['mesh']}")
    ceiling, routing, boundedness = _analytic_checks(rec, hw)

    tol = TOLERANCE.get(rec.dtype, TOLERANCE["float32"])
    accuracy = ClaimResult(
        "accuracy", rec, rec.max_err <= tol,
        f"max_err {rec.max_err:.3g} vs {rec.dtype} tolerance {tol:g}")
    out = [ceiling, routing, accuracy, boundedness]
    if rec.trace:
        out.extend(_trace_checks(rec, hw))
    return tuple(out)


def check_serving_record(rec: ServingRecord,
                         hw: HardwareSpec) -> Tuple[ClaimResult, ...]:
    """Verify the serving claims (§6 routing under load, Eq. 4, latency
    and goodput consistency) for one schema-4 session record.

    Returns one :class:`ClaimResult` per entry in
    :data:`SERVING_CLAIMS`, in order, re-deriving the advisor's decision
    from the recorded intensity so the paper's routing story is checked
    in steady state, not just per call.  Records carrying a model-scale
    ``verdict`` payload (lm sessions) additionally get one result per
    entry in :data:`MODEL_CLAIMS`, and records carrying the observability
    ``trace`` block (serving schema 5) pass :data:`TRACE_CLAIMS`, and
    records carrying an online-tuning ``tuning`` payload one per entry in
    :data:`ONLINE_CLAIMS`.  A session with ``events`` (chaos) or more than
    one shard raises ``NotImplementedError`` naming its ROADMAP item.
    """
    what = f"{rec.kernel}/{rec.engine}/{rec.workload}/{rec.size}"
    if rec.events:
        raise NotImplementedError(f"{what}: {_WAITING['elastic']}")
    if (rec.num_shards or 1) > 1:
        raise NotImplementedError(f"{what}: {_WAITING['mesh']}")
    # Eq. 17/23/24, §6 routing, Eq. 4: the same checks as per-call
    # sweep points, via the shared helper (a record claiming a bigger
    # matrix-engine win than the theory allows is a violation whether
    # it was measured per call or under traffic)
    ceiling, routing, boundedness = _analytic_checks(
        rec, hw, routing_context=f", workload={rec.workload}")
    results = [ceiling, routing, boundedness]

    pct_ok = (0.0 <= rec.p50_ms <= rec.p95_ms + _EPS
              and rec.p95_ms <= rec.p99_ms + _EPS
              and rec.queue_p50_ms >= 0.0 and rec.compute_p50_ms >= 0.0)
    results.append(ClaimResult(
        "percentiles", rec, pct_ok,
        f"p50={rec.p50_ms:.4g} <= p95={rec.p95_ms:.4g} <= "
        f"p99={rec.p99_ms:.4g} ms, queue/compute splits >= 0"))

    throughput = (rec.completed / rec.duration_s
                  if rec.duration_s > 0 else 0.0)
    # goodput = attained/duration; attainment and goodput are rounded
    # independently at record time, so allow that rounding slack
    expect = rec.slo_attainment * throughput
    slack = 0.5 + 0.01 * max(throughput, 1.0)
    goodput_ok = (0.0 <= rec.slo_attainment <= 1.0 + _EPS
                  and rec.completed <= rec.offered
                  and rec.goodput_rps <= throughput + slack
                  and abs(rec.goodput_rps - expect) <= slack)
    results.append(ClaimResult(
        "goodput", rec, goodput_ok,
        f"goodput {rec.goodput_rps:.4g}/s vs attainment "
        f"{rec.slo_attainment:.4g} x throughput {throughput:.4g}/s "
        f"({rec.completed}/{rec.offered} completed)"))
    if rec.verdict:
        results.extend(_verdict_checks(rec, hw))
    if rec.trace:
        results.extend(_serving_trace_checks(rec))
    if rec.tuning:
        results.extend(_online_checks(rec, hw))
    return tuple(results)


def check_records(recsets: Sequence[RecordSet]) -> List[ClaimResult]:
    """Run the kind-appropriate checks over every record of every set.

    Bench sets go through :func:`check_record`, serving sets through
    :func:`check_serving_record`.  The hardware model is resolved per
    record set from its environment metadata (:func:`hw_for`).
    """
    out: List[ClaimResult] = []
    for rs in recsets:
        hw = hw_for(rs)
        check = (check_serving_record if rs.kind == "serving"
                 else check_record)
        for rec in rs.records:
            out.extend(check(rec, hw))
    return out


def violations(results: Iterable[ClaimResult]) -> List[ClaimResult]:
    """The failing subset of *results* -- empty iff the paper's story holds."""
    return [r for r in results if not r.passed]
