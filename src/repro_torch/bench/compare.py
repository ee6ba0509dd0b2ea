"""Regression gate: diff two BENCH record sets and fail on drift.

Usage::

    python -m repro_torch.bench.compare BASELINE_DIR CANDIDATE_DIR \
        [--threshold 0.25] [--kernels scale,triad] [--kind all]

Compares candidate records against the baseline and exits non-zero when

* a candidate sweep point's timed median regresses by more than
  ``--threshold`` (fraction; default 0.25 = 25%),
* a candidate **serving** session's tail latency (``p99_ms``) regresses
  or its ``goodput_rps`` drops by more than ``--threshold``,
* any candidate record violates a paper claim (Eq. 23/24 ceiling, §6
  routing, oracle accuracy, Eq. 4 boundedness -- §6-under-load,
  percentile and goodput consistency and the model-scale verdict for
  serving records -- and ``trace_reconciliation``),
* a joined pair of **online-tuned** sessions (both sides carrying a
  ``tuning`` block from ``serve --online-tune``) grows its total bandit
  regret (``regret_us_total``) by more than the same threshold --
  exploration getting more expensive is an adaptive-control regression,
  gated beside the p99 drift the shared tail gate already catches,
* a joined serving session pair disagrees on its load knobs
  (rate/duration/SLO/seed/batching policy/mesh width/online tune budget):
  sessions under different offered load are not comparable, so drifted
  defaults fail loudly instead of gating noise, or
* a baseline point disappears from the candidate set (lost coverage is
  a regression too).

**What a bench point gates.**  The reference gates ``ref_us_per_call``,
which on its records is the measured kernel.  On the port's records that
field is the plain PyTorch oracle's time and the kernel's median is
``us_per_call``; the gate therefore reads ``BenchRecord.timed_us`` --
``us_per_call`` where recorded, else ``ref_us_per_call`` -- which equals
``ref_us_per_call`` on the reference's own records.  A joined pair where
one side records ``us_per_call`` and the other does not times two
different things, and fails as a config mismatch.

Bench sweep points join on (kernel, engine, size, dtype, mesh width);
serving sessions join on (kernel, engine, workload, size, dtype, mesh
width, tuning mode).  ``--kind`` restricts the gate to one record kind
(``bench``/``serving``; default ``all``); ``--kernels`` restricts both
sides to a comma-separated subset.  Speed-ups and new points are
reported but never fail the gate.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
Queue 1 item when a record set carries what they gate: the
chaos-availability gate (``events``, items 13-14) and the measured-mesh
gate with the ``--mesh`` filter (``shard_spec`` / ``mesh_exec`` / sharded
sessions, item 13).

On failure the log ends with a per-kernel summary table (compared
points, missing points, perf/goodput regressions, config mismatches,
claim violations, status).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from ..report import check_records, load_dir, violations
from ..report.records import BenchRecord, RecordSet, ServingRecord

# bench points key on (kernel, engine, size, dtype, mesh width); serving
# sessions on (kernel, engine, workload, size, dtype, mesh width, tuning
# mode) -- kernel always leads
Key = Tuple[Any, ...]
Record = Union[BenchRecord, ServingRecord]

KINDS = ("all", "bench", "serving")

#: What the port's gate does not cover yet, by the record block it needs.
WAITING = {
    "events": "the chaos availability gate waits for ROADMAP Queue 1 "
              "items 13-14 (sharding, runtime)",
    "mesh": "the mesh gate waits for ROADMAP Queue 1 item 13 (sharding)",
}

#: Serving-session load knobs that must agree on a joined pair.
KNOBS = ("rate_rps", "duration_s", "slo_ms", "seed", "max_batch",
         "max_wait_ms", "num_shards", "mesh_exec_mode", "tune_budget")


@dataclasses.dataclass(frozen=True)
class Failure:
    """One gate failure: its kind, the kernel it belongs to, the text."""

    kind: str      # 'empty'|'missing'|'perf'|'goodput'|'config'|'claim'
    kernel: str    # '' for cross-kernel failures (empty comparison)
    message: str


@dataclasses.dataclass(frozen=True)
class GateResult:
    """Everything ``main`` needs to render an actionable red log."""

    failures: Tuple[Failure, ...]
    compared: Dict[str, int]     # kernel -> points compared

    @property
    def messages(self) -> List[str]:
        """The failure texts (the ``compare`` return value)."""
        return [f.message for f in self.failures]

    def summary_table(self) -> List[str]:
        """Per-kernel summary lines: one row per kernel, PASS rows too."""
        kernels = sorted(set(self.compared) |
                         {f.kernel for f in self.failures if f.kernel})
        rows = [("kernel", "compared", "missing", "perf", "goodput",
                 "config", "claims", "status")]
        for k in kernels:
            counts = {kind: sum(1 for f in self.failures
                                if f.kernel == k and f.kind == kind)
                      for kind in ("missing", "perf", "goodput",
                                   "config", "claim")}
            status = "FAIL" if any(counts.values()) else "pass"
            rows.append((k, str(self.compared.get(k, 0)),
                         str(counts["missing"]), str(counts["perf"]),
                         str(counts["goodput"]), str(counts["config"]),
                         str(counts["claim"]), status))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        return ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                for r in rows]


def _refuse_waiting(rs: RecordSet, rec: Record) -> None:
    """Raise for a record whose gate the port does not have yet."""
    if rs.kind == "serving":
        if rec.events:
            raise NotImplementedError(f"{rs.path}: {WAITING['events']}")
        sharded = (rec.num_shards or 1) > 1
    else:
        sharded = bool(rec.shard_spec or rec.mesh_exec
                       or rec.mesh_devices > 1)
    if sharded:
        raise NotImplementedError(f"{rs.path}: {WAITING['mesh']}")


def _index(recsets: Iterable[RecordSet], which: str,
           kernels: Optional[set] = None) -> Dict[Key, Record]:
    out: Dict[Key, Record] = {}
    for rs in recsets:
        if rs.kind != which:
            continue
        if kernels is not None and rs.kernel not in kernels:
            continue
        for rec in rs.records:
            _refuse_waiting(rs, rec)
            out[rec.point] = rec
    return out


def _diff_points(base: Dict, cand: Dict, label: str,
                 failures: List[Failure]) -> List:
    """Missing-coverage failures + the joined keys both sides share."""
    for key in sorted(set(base) - set(cand)):
        failures.append(Failure(
            "missing", key[0],
            f"missing: {label} {'/'.join(map(str, key))} present in "
            f"baseline but absent from candidate"))
    for key in sorted(set(cand) - set(base)):
        print(f"note: new {label} point {'/'.join(map(str, key))}")
    return sorted(set(base) & set(cand))


def _gate_metric(key, old: float, new: float, metric: str, unit: str,
                 threshold: float, kind: str, failures: List[Failure],
                 lower_is_better: bool = True) -> None:
    """One thresholded metric comparison; regressions fail, wins print."""
    if old <= 0:
        return
    # the higher-is-better bound is division-based so it mirrors the
    # lower-is-better one at any threshold: a 1+t ratio either way fails
    # (a subtractive 1-t bound would go vacuous at t >= 1)
    worse = (new > old * (1.0 + threshold) if lower_is_better
             else new < old / (1.0 + threshold))
    better = (new < old / (1.0 + threshold) if lower_is_better
              else new > old * (1.0 + threshold))
    if worse:
        if lower_is_better:
            evidence = (f"(+{(new / old - 1) * 100:.0f}% > "
                        f"{threshold * 100:.0f}%)")
            label = "perf regression"
        else:
            ratio = old / new if new > 0 else float("inf")
            evidence = (f"({ratio:.1f}x below baseline > "
                        f"{1.0 + threshold:.1f}x bound)")
            label = f"{kind} drop"
        failures.append(Failure(
            kind, key[0],
            f"{label}: {'/'.join(map(str, key))} {metric} "
            f"{old:.1f} -> {new:.1f} {unit} {evidence}"))
    elif better:
        print(f"note: {'/'.join(map(str, key))} {metric} improved "
              f"{old:.1f} -> {new:.1f} {unit}")


def _timed_field(rec: BenchRecord) -> str:
    return "ref_us_per_call" if rec.us_per_call is None else "us_per_call"


def gate(baseline_dir: str, candidate_dir: str, threshold: float = 0.25,
         kernels: Optional[Iterable[str]] = None,
         kind: str = "all") -> GateResult:
    """Run the full gate and return structured per-kernel results.

    ``kind`` selects which record kinds participate: 'bench' sweep
    points, 'serving' session records, or 'all' (both).
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    wanted = set(kernels) if kernels is not None else None
    base_sets = load_dir(baseline_dir)
    cand_sets = [rs for rs in load_dir(candidate_dir)
                 if (wanted is None or rs.kernel in wanted)
                 and kind in ("all", rs.kind)]
    failures: List[Failure] = []
    compared: Dict[str, int] = {}
    empty = True

    if kind in ("all", "bench"):
        base = _index(base_sets, "bench", wanted)
        cand = _index(cand_sets, "bench", wanted)
        empty = empty and not base
        for key in _diff_points(base, cand, "sweep", failures):
            compared[key[0]] = compared.get(key[0], 0) + 1
            field = _timed_field(base[key])
            if field != _timed_field(cand[key]):
                failures.append(Failure(
                    "config", key[0],
                    f"config mismatch: {'/'.join(map(str, key))} points "
                    f"are not comparable (baseline times {field}, "
                    f"candidate {_timed_field(cand[key])})"))
                continue
            _gate_metric(key, base[key].timed_us, cand[key].timed_us,
                         field, "us", threshold, "perf", failures)

    if kind in ("all", "serving"):
        base = _index(base_sets, "serving", wanted)
        cand = _index(cand_sets, "serving", wanted)
        empty = empty and not base

        def _knob(rec, field):
            if field == "tune_budget":
                # exploration budget shapes both regret and the tail:
                # online sessions only gate against the same budget
                return (rec.tuning or {}).get("budget")
            value = getattr(rec, field)
            if field == "num_shards":
                return value or 1  # legacy records: None = unsharded
            return value

        for key in _diff_points(base, cand, "serving", failures):
            compared[key[0]] = compared.get(key[0], 0) + 1
            # the join key carries no load knobs: refuse to compare
            # sessions that saw different offered load or SLO
            mismatched = [
                f"{f}={_knob(base[key], f)} vs {_knob(cand[key], f)}"
                for f in KNOBS
                if _knob(base[key], f) != _knob(cand[key], f)]
            if mismatched:
                failures.append(Failure(
                    "config", key[0],
                    f"config mismatch: {'/'.join(map(str, key))} "
                    f"sessions are not comparable "
                    f"({'; '.join(mismatched)})"))
                continue
            _gate_metric(key, base[key].p99_ms, cand[key].p99_ms,
                         "p99_ms", "ms", threshold, "perf", failures)
            _gate_metric(key, base[key].goodput_rps,
                         cand[key].goodput_rps, "goodput_rps", "rps",
                         threshold, "goodput", failures,
                         lower_is_better=False)
            b_tu, c_tu = base[key].tuning, cand[key].tuning
            if b_tu and c_tu:
                # both sides tuned online under the same budget: total
                # regret is the price the bandit paid to explore
                _gate_metric(key, float(b_tu.get("regret_us_total", 0.0)),
                             float(c_tu.get("regret_us_total", 0.0)),
                             "regret_us_total", "us", threshold, "perf",
                             failures)

    if empty:
        # an over-narrow --kernels/--kind filter must not pass vacuously
        failures.insert(0, Failure(
            "empty", "",
            f"empty comparison: no baseline records in {baseline_dir!r} "
            f"match kernels={sorted(wanted) if wanted else 'all'} "
            f"kind={kind} mesh=all"))

    for v in violations(check_records(cand_sets)):
        failures.append(Failure(
            "claim", v.record.kernel,
            f"claim violation: {'/'.join(map(str, v.record.point))} "
            f"[{v.claim}] {v.detail}"))
    return GateResult(failures=tuple(failures), compared=compared)


def compare(baseline_dir: str, candidate_dir: str, threshold: float = 0.25,
            kernels: Optional[Iterable[str]] = None,
            kind: str = "all") -> List[str]:
    """Return the list of failure messages (empty = gate passes)."""
    return gate(baseline_dir, candidate_dir, threshold=threshold,
                kernels=kernels, kind=kind).messages


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("baseline", help="directory of baseline BENCH_*.json")
    p.add_argument("candidate", help="directory of candidate BENCH_*.json")
    p.add_argument("--threshold", type=float, default=0.25,
                   help="max allowed regression fraction (default 0.25)")
    p.add_argument("--kernels", default=None,
                   help="comma-separated kernel subset to compare")
    p.add_argument("--kind", default="all", choices=KINDS,
                   help="record kind to gate: bench sweeps, serving "
                        "sessions, or all (default)")
    args = p.parse_args(argv)
    kernels = args.kernels.split(",") if args.kernels else None
    result = gate(args.baseline, args.candidate,
                  threshold=args.threshold, kernels=kernels,
                  kind=args.kind)
    for f in result.failures:
        print(f"FAIL: {f.message}", file=sys.stderr)
    if result.failures:
        print(f"\n{len(result.failures)} gate failure(s); per-kernel "
              "summary:", file=sys.stderr)
        for line in result.summary_table():
            print(line, file=sys.stderr)
        return 1
    print("gate passed: no perf regressions, no claim violations")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
