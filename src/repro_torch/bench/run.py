"""Benchmark harness of the port.

    python -m repro_torch.bench [bounds|roofline|kernels|<kernel>] [--out DIR]
        [--trace FILE] [--verbose] [--stream] [--device cpu]
    python -m repro_torch.bench serve [--workload lm] [--device cpu] ...

  bounds         -- Table 1 + Eq. 14/23/24 (theory)
  roofline       -- Fig. 2 (two-ceiling roofline placements)
  kernels        -- every registered kernel x engine x size x dtype
  <kernel name>  -- one registered kernel (e.g. ``scale``, ``triad``)
  serve          -- request-level serving sessions (see
                    :mod:`repro_torch.bench.serve` for its flags)

Prints ``name,us_per_call,derived`` CSV rows; kernel sweeps also write
``DIR/BENCH_<kernel>.json`` (default ``build/runs_torch``).  Sweeps run on
the card, with the hardware model of the card's name, unless
``--device cpu`` is given, which runs the kernels' plain versions on the
CPU against the default advisor's model.  ``--stream`` adds the STREAM
points (every array >= 4x L2; the card only).  ``--trace FILE`` exports
every span of the sweep as Chrome-trace JSON.  ``--verbose`` raises the
structured logger to info.

Not ported yet, and refused with a message naming the ROADMAP item:
``tune`` (Queue 1 item 12), ``report`` (the render follow-up of item 8),
``--mesh`` / ``--real`` (item 13) and ``--tuned`` (item 12).
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

#: Reference subcommands and flags the port has no counterpart for yet.
WAITING_COMMANDS = {
    "tune": "ROADMAP Queue 1 item 12 (tuning)",
    "report": "the render follow-up of ROADMAP Queue 1 item 8 "
              "(report/render.py)",
}
WAITING_FLAGS = {
    "--mesh": "ROADMAP Queue 1 item 13 (sharding)",
    "--real": "ROADMAP Queue 1 item 13 (sharding)",
    "--tuned": "ROADMAP Queue 1 item 12 (tuning)",
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


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        from . import serve
        raise SystemExit(serve.main(argv[1:]))
    waiting = [w for w in WAITING_FLAGS if w in argv]
    if argv and argv[0] in WAITING_COMMANDS:
        waiting.insert(0, argv[0])
    if waiting:
        item = {**WAITING_COMMANDS, **WAITING_FLAGS}[waiting[0]]
        raise SystemExit(f"{waiting[0]} is not ported yet: it waits for "
                         f"{item}")
    out_given = "--out" in argv
    out_dir = _take_flag(argv, "--out", "a directory argument") or DEFAULT_OUT
    trace_out = _take_flag(argv, "--trace", "an output path argument")
    device = _take_flag(argv, "--device", "'cuda' or 'cpu'") or "cuda"
    stream = _take_switch(argv, "--stream")
    if _take_switch(argv, "--verbose"):
        from ..obs.log import LOG
        LOG.configure(level="info")
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be 'cuda' or 'cpu', got {device!r}")
    kernel_names = set(registry.names())
    which = argv or (sorted(THEORY) + ["kernels"])
    unknown = [k for k in which
               if k not in THEORY and k != "kernels" and k not in kernel_names]
    if unknown:
        raise SystemExit(
            f"unknown benchmark {unknown[0]!r}; have "
            f"{sorted(THEORY) + ['kernels'] + sorted(kernel_names)}")
    sweeps = [k for k in which if k not in THEORY]
    for flag, given in (("--out", out_given), ("--trace", trace_out),
                        ("--stream", stream)):
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
                                    device=device))


if __name__ == "__main__":
    main()
