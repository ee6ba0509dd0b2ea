"""Benchmark harness of the port.

    python -m repro_torch.bench [bounds|roofline|kernels|<kernel>] [--out DIR]
        [--trace FILE] [--verbose] [--stream] [--tuned FILE] [--device cpu]
    python -m repro_torch.bench serve [--workload lm] [--device cpu] ...
    python -m repro_torch.bench tune [--kernel K] [--size N] [--out FILE]
    python -m repro_torch.bench report [DIR]

  bounds         -- Table 1 + Eq. 14/23/24 (theory)
  roofline       -- Fig. 2 (two-ceiling roofline placements)
  kernels        -- every registered kernel x engine x size x dtype
  <kernel name>  -- one registered kernel (e.g. ``scale``, ``triad``)
  serve          -- request-level serving sessions (see
                    :mod:`repro_torch.bench.serve` for its flags)
  tune           -- tile-config autotuner on the card -> tuned.json (see
                    :mod:`repro_torch.bench.tune` for its flags)
  report         -- REPORT.md + per-kernel pages from a records directory
                    (default build/runs_torch), written into that
                    directory (``REPORT.md``, ``docs/benchmarks/``)

Prints ``name,us_per_call,derived`` CSV rows; kernel sweeps also write
``DIR/BENCH_<kernel>.json`` (default ``build/runs_torch``).  Sweeps run on
the card, with the hardware model of the card's name, unless
``--device cpu`` is given, which runs the kernels' plain versions on the
CPU against the default advisor's model.  ``--stream`` adds the STREAM
points (every array >= 4x L2; the card only).  ``--trace FILE`` exports
every span of the sweep as Chrome-trace JSON.  ``--verbose`` raises the
structured logger to info.  ``--tuned FILE`` sweeps with the tuned tile
configs of a ``tuned.json``: each engine is launched and timed with its
cached tile, and each record carries ``tile_config`` (``params``,
``tuned_us``, ``default_us``, ``source``).

Not ported yet, and refused with a message naming the ROADMAP item:
``--mesh`` / ``--real`` (item 13).
"""
from __future__ import annotations

import sys
from typing import List, Optional

from ..kernels import registry
from . import bench_bounds, bench_kernels, bench_roofline
from .common import emit

THEORY = {
    "bounds": bench_bounds,
    "roofline": bench_roofline,
}

DEFAULT_OUT = "build/runs_torch"

#: Reference flags the port has no counterpart for yet.
WAITING_FLAGS = {
    "--mesh": "ROADMAP Queue 1 item 13 (sharding)",
    "--real": "ROADMAP Queue 1 item 13 (sharding)",
}


def _take_flag(argv: List[str], flag: str, what: str) -> Optional[str]:
    """Pop ``flag VALUE`` out of argv, returning VALUE (or None)."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    try:
        value = argv[i + 1]
    except IndexError:
        raise SystemExit(f"{flag} requires {what}")
    del argv[i:i + 2]
    return value


def _take_switch(argv: List[str], flag: str) -> bool:
    if flag not in argv:
        return False
    argv.remove(flag)
    return True


def _report(argv: List[str], out_dir: Optional[str]) -> None:
    """`report` subcommand: records -> verified REPORT.md + pages, written
    beside the records (never into the repository's own docs)."""
    import os

    from ..report import write_report

    if out_dir is not None and argv:
        raise SystemExit("report: pass the records dir positionally or "
                         "via --out, not both")
    if len(argv) > 1:
        raise SystemExit(f"report takes one records dir, got {argv}")
    runs_dir = argv[0] if argv else (out_dir or DEFAULT_OUT)
    for path in write_report(
            runs_dir=runs_dir,
            report_path=os.path.join(runs_dir, "REPORT.md"),
            docs_dir=os.path.join(runs_dir, "docs", "benchmarks")):
        print(f"wrote {path}")


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        from . import serve
        raise SystemExit(serve.main(argv[1:]))
    if argv and argv[0] == "tune":
        from . import tune
        raise SystemExit(tune.main(argv[1:]))
    waiting = [w for w in WAITING_FLAGS if w in argv]
    if waiting:
        raise SystemExit(f"{waiting[0]} is not ported yet: it waits for "
                         f"{WAITING_FLAGS[waiting[0]]}")
    out_given = "--out" in argv
    out_arg = _take_flag(argv, "--out", "a directory argument")
    out_dir = out_arg or DEFAULT_OUT
    tuned = _take_flag(argv, "--tuned", "a tuned.json path argument")
    trace_out = _take_flag(argv, "--trace", "an output path argument")
    device = _take_flag(argv, "--device", "'cuda' or 'cpu'") or "cuda"
    stream = _take_switch(argv, "--stream")
    if _take_switch(argv, "--verbose"):
        from ..obs.log import LOG
        LOG.configure(level="info")
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be 'cuda' or 'cpu', got {device!r}")
    if argv and argv[0] == "report":
        # the report is a pure function of the records: a sweep flag
        # silently ignored would lie about what was rendered
        for flag, given in (("--tuned", tuned), ("--trace", trace_out),
                            ("--stream", stream)):
            if given:
                raise SystemExit(f"{flag} only applies to kernel sweeps")
        _report(argv[1:], out_arg)
        return
    kernel_names = set(registry.names())
    which = argv or (sorted(THEORY) + ["kernels"])
    unknown = [k for k in which
               if k not in THEORY and k != "kernels" and k not in kernel_names]
    if unknown:
        raise SystemExit(
            f"unknown benchmark {unknown[0]!r}; have "
            f"{sorted(THEORY) + ['kernels', 'report', 'serve', 'tune']}"
            f" + {sorted(kernel_names)}")
    sweeps = [k for k in which if k not in THEORY]
    for flag, given in (("--out", out_given), ("--trace", trace_out),
                        ("--stream", stream), ("--tuned", tuned)):
        if given and not sweeps:
            raise SystemExit(f"{flag} only applies to kernel sweeps")
    if sweeps:
        import torch
        if device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("no card (torch.cuda.is_available() is false); "
                             "pass --device cpu to run the plain versions")
        if stream and device != "cuda":
            raise SystemExit("--stream measures the card's HBM: it needs "
                             "--device cuda")
        # IEEE float32 everywhere: the oracles' matmuls must not use TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print("name,us_per_call,derived")
    for key in which:
        if key in THEORY:
            emit(THEORY[key].rows())
        else:
            names = None if key == "kernels" else [key]
            emit(bench_kernels.rows(names, json_dir=out_dir,
                                    trace_out=trace_out, stream=stream,
                                    device=device, tuned=tuned))


if __name__ == "__main__":
    main()
