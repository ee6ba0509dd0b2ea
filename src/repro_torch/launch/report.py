"""Render the dry run's rows (``build/runs_torch/dryrun.json``) into the
roofline tables, as the reference's ``launch/report.py`` renders its
``runs/dryrun.json``: the same sections, byte for byte on the same rows.

Usage: python -m repro_torch.launch.report [--json F] [--mesh 16x16]
       [--section dryrun|roofline|summary]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from .dryrun import DEFAULT_OUT

__all__ = ["ADVICE", "dryrun_table", "main", "roofline_table", "summary"]


def _fmt_t(x):
    return f"{x*1e3:.2f}ms" if x < 1 else f"{x:.3f}s"


ADVICE = {
    "compute": ("cut recompute (remat policy) or raise per-chip math "
                "efficiency (fewer wasted dispatch FLOPs)"),
    "memory": ("shrink activation/cache traffic: sequence-parallel resident "
               "activations, bf16/int8 caches, fused loss"),
    "collective": ("replace per-layer TP all-reduce with reduce-scatter+"
                   "all-gather (SP) or weight-gathered (ZeRO-3) layout"),
}


def dryrun_table(rows, mesh="16x16"):
    """Per row: GiB per device, arguments, temp, collectives, trace s."""
    out = ["| arch | cell | GiB/dev | args | temp | collectives (per-dev) | compile |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['cell']} | -- | -- | -- | "
                       f"skipped: {r['skipped'][:60]}... | -- |")
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['cell']} | ERROR | | | "
                       f"{r['error'][:60]} | |")
            continue
        b = r["bytes_per_device"]
        coll = r["collectives"]["bytes_by_kind"]
        coll_s = ", ".join(f"{k.replace('all-', 'a')}:{v/2**30:.2f}G"
                           for k, v in sorted(coll.items()) if v)
        out.append(
            f"| {r['arch']} | {r['cell']} | {b['total_gb']:.1f} "
            f"| {b['arguments']/2**30:.1f}G | {b['temp']/2**30:.1f}G "
            f"| {coll_s or 'none'} | {r['lower_compile_s']}s |")
    return "\n".join(out)


def roofline_table(rows, mesh="16x16"):
    """Per ok row: the three terms, the dominant one and what moves it."""
    hdr = ("| arch | cell | t_comp | t_mem | t_coll | dominant | "
           "MODEL_FLOPs | useful | MFU@bound | what moves the dominant term |")
    out = [hdr, "|" + "---|" * 10]
    for r in rows:
        if r.get("mesh") != mesh or "skipped" in r or "error" in r:
            continue
        if "t_compute_s" not in r:
            continue
        out.append(
            f"| {r['arch']} | {r['cell']} | {_fmt_t(r['t_compute_s'])} "
            f"| {_fmt_t(r['t_memory_s'])} | {_fmt_t(r['t_collective_s'])} "
            f"| **{r['dominant']}** | {r['model_flops']:.3g} "
            f"| {r['useful_ratio']:.2f} | {r['mfu_bound']*100:.1f}% "
            f"| {ADVICE[r['dominant']]} |")
    return "\n".join(out)


def summary(rows):
    """Per mesh: how many rows are ok, skipped and errors."""
    meshes = {}
    for r in rows:
        m = r.get("mesh", "?")
        meshes.setdefault(m, {"ok": 0, "skip": 0, "err": 0})
        if "error" in r:
            meshes[m]["err"] += 1
        elif "skipped" in r:
            meshes[m]["skip"] += 1
        else:
            meshes[m]["ok"] += 1
    return meshes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=DEFAULT_OUT)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--section", choices=("dryrun", "roofline", "summary"),
                    default="roofline")
    args = ap.parse_args(argv)
    rows = json.loads(Path(args.json).read_text())
    rows.sort(key=lambda r: (r.get("arch", ""), r.get("cell", "")))
    if args.section == "dryrun":
        print(dryrun_table(rows, args.mesh))
    elif args.section == "roofline":
        print(roofline_table(rows, args.mesh))
    else:
        print(json.dumps(summary(rows), indent=1))


if __name__ == "__main__":
    main()
