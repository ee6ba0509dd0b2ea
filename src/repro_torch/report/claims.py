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

Records carrying the obs ``trace`` block additionally pass
**trace_reconciliation** (:data:`TRACE_CLAIMS`): the span count equals
the timing iterations, the span median equals the recorded median
within rounding (the span *is* the sample), and the roofline gauge
re-derives exactly from the record's own traffic, time and hardware
model.  The recorded median is the engine kernel's ``us_per_call``
where the record has it (the port's sweep) and the oracle's
``ref_us_per_call`` otherwise (the reference's records).

Two differences from the reference, both so that nothing passes
silently: :func:`hw_for` raises on a hardware model it does not know,
where the reference falls back to the TPU v5e; and records that need
claims the port does not have yet (serving sessions, and the mesh fields
``shard_spec`` / ``mesh_exec``) raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

from ..core.advisor import EngineAdvisor
from ..core.balance import machine_balance
from ..core.bounds import tensor_core_upper_bound, workload_upper_bound
from ..core.hw import PLATFORMS, HardwareSpec
from ..core.intensity import KernelTraits
from ..obs.counters import roofline_sample
from .records import BenchRecord, RecordSet

__all__ = ["CLAIMS", "ClaimResult", "SAMPLE_CLOCKS", "TOLERANCE",
           "TRACE_CLAIMS", "ceiling_bound", "check_record",
           "check_records", "hw_for", "violations"]

#: Claim identifiers, in report order.
CLAIMS = ("ceiling", "routing", "accuracy", "boundedness")

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
    "serving": "the serving claims wait for ROADMAP Queue 1 item 11 "
               "(serving)",
    "mesh": "the shard and mesh claims wait for ROADMAP Queue 1 item 13 "
            "(sharding)",
}


@dataclasses.dataclass(frozen=True)
class ClaimResult:
    """Outcome of one claim check against one bench record."""

    claim: str           # one of CLAIMS / TRACE_CLAIMS
    record: BenchRecord
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


def _analytic_checks(rec: BenchRecord,
                     hw: HardwareSpec) -> List[ClaimResult]:
    """The ceiling / routing / boundedness checks (Eq. 17/23/24, §6, Eq. 4)."""
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
        f"(memory_bound={rec.memory_bound})"))

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


def check_records(recsets: Sequence[RecordSet]) -> List[ClaimResult]:
    """Run :func:`check_record` over every record of every set.

    The hardware model is resolved per record set from its environment
    metadata (:func:`hw_for`).  A serving set raises
    ``NotImplementedError``, as a mesh record does.
    """
    out: List[ClaimResult] = []
    for rs in recsets:
        if rs.kind == "serving":
            raise NotImplementedError(f"{rs.path}: {_WAITING['serving']}")
        hw = hw_for(rs)
        for rec in rs.records:
            out.extend(check_record(rec, hw))
    return out


def violations(results: Iterable[ClaimResult]) -> List[ClaimResult]:
    """The failing subset of *results* -- empty iff the paper's story holds."""
    return [r for r in results if not r.passed]
