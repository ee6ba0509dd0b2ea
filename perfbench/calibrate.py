"""Readings that set a cell's limits: the program's numbers on many seeds
and the control's on a few, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        --control-seeds 21 22 23 --seconds <s> [--out DIR]

Each seed is one whole run of the cell (set-up, a window of ``--seconds``
at the cell's own size, the check).  A control seed runs the program's
window as well (the served tokens the control is read at), then puts the
reference computed one precision lower (TF32 operands) in the program's
place.  Prints one line per run and, per number compared, the largest
reading of the program (the lower reading) and the smallest of the
control (the upper one); writes them to ``DIR/calibrate-<cell>.json``.
The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from perfbench.harness import core  # noqa: E402


def main(argv=None) -> int:
    """The command line (module docstring)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=str(core.OUT))
    args = ap.parse_args(argv)
    bench = core.benchmark()
    core.prepare_environment()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from perfbench.harness.runner import run_cell
    from perfbench.reference import no_tf32
    no_tf32(torch)
    torch.set_float32_matmul_precision("highest")
    rows = []
    runs = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.control_seeds]
    for seed, control in runs:
        t0 = time.perf_counter()
        r = run_cell(torch, bench=bench, cell=args.workload, seed=seed,
                     seconds=args.seconds, trace=False, device="cuda",
                     t_start=t0, control=control)
        row = {"seed": seed, "control": control, "correct": r["correct"],
               "numbers": {k: v["value"] for k, v in r["checks"].items()},
               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
               "memory_peak_bytes": r["device"]["memory_peak_bytes"],
               "kind": r["device"]["kind"],
               "power_limit_w": r["device"]["power_limit_w"],
               "run_s": time.perf_counter() - t0}
        rows.append(row)
        print("calibrate " + json.dumps(row), flush=True)
    summary = {}
    for name in core.workload(args.workload)["limits"]:
        prog = [r["numbers"][name] for r in rows if not r["control"]]
        ctl = [r["numbers"][name] for r in rows if r["control"]]
        summary[name] = {"lower": max(prog) if prog else None,
                         "upper": min(ctl) if ctl else None,
                         "program": prog, "control": ctl}
    print("calibrate-summary " + json.dumps(summary), flush=True)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"calibrate-{args.workload}.json", "w") as f:
        json.dump({"runs": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
