"""Regression gate: diff two BENCH record sets and fail on drift.

Usage::

    python -m repro_torch.bench.compare BASELINE_DIR CANDIDATE_DIR \
        [--threshold 0.25] [--kernels scale,triad] [--kind all] \
        [--mesh all|N]

Compares candidate records against the baseline and exits non-zero when

* a candidate sweep point's timed median regresses by more than
  ``--threshold`` (fraction; default 0.25 = 25%),
* a candidate **serving** session's tail latency (``p99_ms``) regresses
  or its ``goodput_rps`` drops by more than ``--threshold``,
* any candidate record violates a paper claim (Eq. 23/24 ceiling, §6
  routing, oracle accuracy, Eq. 4 boundedness -- §6-under-load,
  percentile and goodput consistency and the model-scale verdict for
  serving records -- and ``trace_reconciliation``),
* a joined pair of **chaos** serving sessions (both sides carrying an
  ``events`` block from ``serve --chaos``) drops its availability under
  failure by more than the same threshold,
* a joined pair of **online-tuned** sessions (both sides carrying a
  ``tuning`` block from ``serve --online-tune``) grows its total bandit
  regret (``regret_us_total``) by more than the same threshold --
  exploration getting more expensive is an adaptive-control regression,
  gated beside the p99 drift the shared tail gate already catches,
* a joined serving session pair disagrees on its load knobs
  (rate/duration/SLO/seed/batching policy/mesh width/chaos spec/online
  tune budget): sessions under different offered load, sharding or
  injected adversary are not comparable, so drifted defaults fail loudly
  instead of gating noise, or
* a baseline point disappears from the candidate set (lost coverage is
  a regression too, including a lost mesh width).

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
(``bench``/``serving``; default ``all``); ``--mesh N`` restricts both
bench points and serving sessions to the width they ran at (``--mesh 1``
= the single-device records only; the default ``all`` demands every
baseline width); ``--kernels`` restricts both sides to a comma-separated
subset.  Speed-ups and new points are reported but never fail the gate.

A joined pair of points measured on ranks (both sides carrying
``mesh_exec``) also gates its ``mesh_wall_us`` and its measured-over-
virtual ``skew`` at the same threshold; a baseline-only ``mesh_exec`` is
not blamed on a candidate swept without ``--real``.  Sessions charged on
the measured mesh join on ``mesh_exec_mode`` like any other knob.

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

#: Serving-session load knobs that must agree on a joined pair.
KNOBS = ("rate_rps", "duration_s", "slo_ms", "seed", "max_batch",
         "max_wait_ms", "num_shards", "mesh_exec_mode", "chaos_spec",
         "tune_budget")


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


def _index(recsets: Iterable[RecordSet], which: str,
           kernels: Optional[set] = None,
           mesh: Optional[int] = None) -> Dict[Key, Record]:
    out: Dict[Key, Record] = {}
    for rs in recsets:
        if rs.kind != which:
            continue
        if kernels is not None and rs.kernel not in kernels:
            continue
        for rec in rs.records:
            # filter on the requested mesh width, matching the join key:
            # a clamped sweep (fewer effective shards than the mesh asked
            # for) still belongs to the width it ran under; serving
            # sessions filter on their own width field
            if mesh is not None:
                width = (rec.mesh_devices if which == "bench"
                         else (rec.num_shards or 1))
                if width != mesh:
                    continue
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
         kind: str = "all", mesh: Optional[int] = None) -> GateResult:
    """Run the full gate and return structured per-kernel results.

    ``kind`` selects which record kinds participate: 'bench' sweep
    points, 'serving' session records, or 'all' (both).  ``mesh``
    restricts both to one shard width (None = every width the baseline
    covers).
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
        base = _index(base_sets, "bench", wanted, mesh)
        cand = _index(cand_sets, "bench", wanted, mesh)
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
            b_mex, c_mex = base[key].mesh_exec, cand[key].mesh_exec
            if b_mex and c_mex:
                # both sides measured on ranks: the mesh wall and the skew
                # gate like any other time
                _gate_metric(key, float(b_mex["mesh_wall_us"]),
                             float(c_mex["mesh_wall_us"]), "mesh_wall_us",
                             "us", threshold, "perf", failures)
                _gate_metric(key, float(b_mex.get("skew", 0.0)),
                             float(c_mex.get("skew", 0.0)), "mesh_skew",
                             "x", threshold, "perf", failures)

    if kind in ("all", "serving"):
        base = _index(base_sets, "serving", wanted, mesh)
        cand = _index(cand_sets, "serving", wanted, mesh)
        empty = empty and not base

        def _knob(rec, field):
            if field == "chaos_spec":
                # the injected fault/resize schedule is a load knob too: a
                # chaos session only gates against a baseline that
                # suffered the same adversary
                return (rec.events or {}).get("spec")
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
            b_ev, c_ev = base[key].events, cand[key].events
            if b_ev and c_ev:
                # both sides are chaos sessions under the same spec:
                # availability under failure is a first-class serving
                # metric -- a recovery path that starts dropping requests
                # fails here even before elastic_integrity goes red
                _gate_metric(key, float(b_ev.get("availability", 0.0)),
                             float(c_ev.get("availability", 0.0)),
                             "availability", "", threshold, "goodput",
                             failures, lower_is_better=False)
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
            f"kind={kind} mesh={mesh if mesh is not None else 'all'}"))

    for v in violations(check_records(cand_sets)):
        failures.append(Failure(
            "claim", v.record.kernel,
            f"claim violation: {'/'.join(map(str, v.record.point))} "
            f"[{v.claim}] {v.detail}"))
    return GateResult(failures=tuple(failures), compared=compared)


def compare(baseline_dir: str, candidate_dir: str, threshold: float = 0.25,
            kernels: Optional[Iterable[str]] = None,
            kind: str = "all", mesh: Optional[int] = None) -> List[str]:
    """Return the list of failure messages (empty = gate passes)."""
    return gate(baseline_dir, candidate_dir, threshold=threshold,
                kernels=kernels, kind=kind, mesh=mesh).messages


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
    p.add_argument("--mesh", default="all",
                   help="mesh filter: a shard count (1 = the single-device "
                        "records) or 'all' to demand every baseline mesh "
                        "width (default)")
    args = p.parse_args(argv)
    kernels = args.kernels.split(",") if args.kernels else None
    if args.mesh == "all":
        mesh = None
    else:
        try:
            mesh = int(args.mesh)
        except ValueError:
            raise SystemExit(
                f"--mesh must be an integer or 'all', got {args.mesh!r}")
    result = gate(args.baseline, args.candidate,
                  threshold=args.threshold, kernels=kernels,
                  kind=args.kind, mesh=mesh)
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
