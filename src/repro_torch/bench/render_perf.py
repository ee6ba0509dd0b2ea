"""Render the §Perf tables of three cells from the dry run's rows, as the
reference's ``benchmarks/render_perf.py`` does: per cell, the baseline
row (the Megatron tensor-parallel layout, 16x16) of ``dryrun.json``, then
every row of ``hillclimb.json`` for that cell.

``hillclimb.json`` is a list of dry-run rows, each with a ``tag`` naming
its options (``launch.dryrun --tag``).  No code in either package writes
it: it is assembled by hand from tagged dry runs.  Without it the tables
hold their baselines only.

Usage: python -m repro_torch.bench.render_perf [--dryrun F] [--hillclimb F]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List

__all__ = ["CELLS", "main", "render"]

CELLS = [("qwen2-vl-72b", "train_4k"), ("deepseek-v2-lite-16b", "train_4k"),
         ("qwen1.5-32b", "decode_32k")]


def _row(tag, r) -> str:
    return (f"| {tag} | {r['t_compute_s']:.3f}s | {r['t_memory_s']:.3f}s "
            f"| {r['t_collective_s']:.3f}s | **{r['t_bound_s']:.3f}s** "
            f"| {r['dominant']} | {r['mfu_bound']*100:.1f}% "
            f"| {r['bytes_per_device']['total_gb']:.1f} |")


def render(dryrun_rows: List[dict], hillclimb_rows: List[dict]) -> str:
    """The reference's printed output for these rows."""
    base = {(r['arch'], r['cell']): r for r in dryrun_rows
            if r.get('mesh') == '16x16' and 't_compute_s' in r}
    hc = [r for r in hillclimb_rows if 't_compute_s' in r]
    lines = []
    for arch, cell in CELLS:
        b = base[(arch, cell)]
        lines.append(f"\n#### {arch} / {cell}\n")
        lines.append("| config | t_comp | t_mem | t_coll | bound | dominant "
                     "| MFU@bound | GiB/dev |")
        lines.append("|---|---|---|---|---|---|---|---|")
        lines.append(_row("baseline (paper-faithful Megatron-TP)", b))
        for r in hc:
            if (r['arch'], r['cell']) == (arch, cell):
                lines.append(_row(r['tag'], r))
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="build/runs_torch/dryrun.json")
    ap.add_argument("--hillclimb", default="build/runs_torch/hillclimb.json")
    args = ap.parse_args(argv)
    with open(args.dryrun) as f:
        rows = json.load(f)
    hc = []
    if os.path.exists(args.hillclimb):
        with open(args.hillclimb) as f:
            hc = json.load(f)
    print(render(rows, hc), end="")


if __name__ == "__main__":
    main()
