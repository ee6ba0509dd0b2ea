#!/usr/bin/env python3
"""Two dry-run sweeps' rows side by side, as a markdown table.

    python3 tools/dryrun_side_by_side.py PORT.json REFERENCE.json

``PORT.json`` is the port's ``python -m repro_torch.launch.dryrun --all
--hw v5e --out PORT.json`` (the reference's terms), ``REFERENCE.json``
the reference's ``python -m repro.launch.dryrun --all --out
REFERENCE.json`` (give it an ``--out`` outside the repo: its default is
the JAX package's ``runs/dryrun.json``).  One line per arch, one column
per cell: GiB per device, the dominant term (its first four letters) and
``t_bound_s``, each as port / reference, then each one's collective
bytes per device by kind in GB (``ag`` all-gather, ``ar`` all-reduce,
``rs`` reduce-scatter, ``a2a`` all-to-all, ``cp`` collective-permute;
the port's give their bfloat16 share in parentheses, which XLA's CPU
backend reduces in float32 and so counts twice).  A cell both skip
reads "skipped"; an error or a one-sided skip shows its reason.  Reads
JSON only: no JAX, no torch.
"""
from __future__ import annotations

import json
import sys

KINDS = (("all-gather", "ag"), ("all-reduce", "ar"),
         ("reduce-scatter", "rs"), ("all-to-all", "a2a"),
         ("collective-permute", "cp"))


def _rows(path):
    return {(r["arch"], r["cell"]): r for r in json.load(open(path))
            if r.get("mesh") == "16x16" and not r.get("tag")}


def _coll(row, bf16=False):
    c = row["collectives"]["bytes_by_kind"]
    half = row["collectives"].get("bf16_bytes_by_kind", {}) if bf16 else {}
    parts = []
    for kind, short in KINDS:
        if c.get(kind):
            text = f"{short} {c[kind] / 1e9:.4g}"
            if half.get(kind):
                text += f" (bf16 {half[kind] / 1e9:.4g})"
            parts.append(text)
    return ", ".join(parts) or "none"


CELLS = ("decode_32k", "long_500k", "prefill_32k", "train_4k")


def _cell(port, ref) -> str:
    """One (arch, cell): 'GiB/dev, dominant, t_bound_s' each as port /
    reference, then each one's collectives."""
    if port is None or ref is None:
        return "missing"
    for row in (port, ref):
        if "skipped" in row or "error" in row:
            if port.get("skipped") and ref.get("skipped"):
                return "skipped"
            return (f"port {port.get('error') or port.get('skipped') or 'ok'}"
                    f"; ref {ref.get('error') or ref.get('skipped') or 'ok'}")
    gib = (f"{port['bytes_per_device']['total_gb']:.2f} / "
           f"{ref['bytes_per_device']['total_gb']:.2f} GiB")
    dom = f"{port['dominant'][:4]} / {ref['dominant'][:4]}"
    t = f"{port['t_bound_s']:.4g} / {ref['t_bound_s']:.4g} s"
    return (f"{gib}, {dom}, {t}; port {_coll(port, True)}; "
            f"ref {_coll(ref)}")


def table(port: dict, ref: dict) -> str:
    """One line per arch, one column per cell."""
    lines = ["| arch | " + " | ".join(CELLS) + " |",
             "|---" * (len(CELLS) + 1) + "|"]
    for arch in sorted({a for a, _ in port} | {a for a, _ in ref}):
        lines.append(f"| {arch} | " + " | ".join(
            _cell(port.get((arch, c)), ref.get((arch, c))) for c in CELLS)
            + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        sys.exit(__doc__)
    print(table(_rows(args[0]), _rows(args[1])))


if __name__ == "__main__":
    main()
