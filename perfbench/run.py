"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the card(s) the cell asks
for. Set-up (``setup_s``: from the process's start to the first timed
call: imports, the card's context, the kernels' build, inputs and
weights from the seed, warm-up), a window of ``--seconds`` that ends in
a synchronisation, the check of what the window produced against the
plain reference, and the cell's end-to-end metrics (``--trace 0``) or
per-layer metrics from a profiled stretch of the window (``--trace 1``).
The last lines on standard error give each number compared beside its
limit; the last line on standard output is the result as one JSON
object. Exits 2 without a result where there is no card or too few, 3
where a forbidden module (JAX or the JAX package) was loaded.
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
    ap.add_argument("--workload", required=True, help="a cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = core.benchmark()
    entry = core.cell_entry(bench, args.workload)
    core.prepare_environment()
    t_import = time.perf_counter()
    import torch
    t_import = time.perf_counter() - t_import
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {entry['chips']} CUDA "
              f"card(s); this machine has {n}", file=sys.stderr)
        return 2
    print(f"[perfbench] process start to the card: "
          f"{time.perf_counter() - T_START:.2f} s (import torch "
          f"{t_import:.2f} s)", file=sys.stderr)
    from perfbench.harness.runner import run_cell
    from perfbench.reference import no_tf32
    no_tf32(torch)
    torch.set_float32_matmul_precision("highest")
    try:
        result = run_cell(torch, bench=bench, cell=args.workload,
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda",
                          t_start=T_START)
    except core.ImportGuardError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    bad = core.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        verdict = "ok" if name not in core.failing({name: v}) else "FAILED"
        print(f"check {name}: {v['value']!r} limit {v['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
