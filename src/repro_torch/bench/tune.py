"""``python -m repro_torch.bench tune``: search tile configs, persist winners.

Usage::

    python -m repro_torch.bench tune [--kernel K] [--budget N]
        [--out build/runs_torch/tuned.json] [--size N] [--dtype D]
        [--seed N] [--device cuda|cpu]

Per (kernel family, engine, dtype) the tuner enumerates the family's
declared ``tile_space`` (capped at ``--budget`` candidates, static default
always included), times each candidate's hand-written kernel on the card,
and records the winner in a schema-2 ``tuned.json`` that
``repro_torch.core.dispatch.TuningPolicy`` consults at dispatch time
(``--tuned FILE`` on a sweep, ``REPRO_TORCH_TUNED_JSON``).  An existing
``--out`` file is merged (faster ``best_us`` wins per key), so repeated
partial runs accumulate.  ``--size`` defaults to each family's largest
reference bench size, which on the card fits in the L2: pass a STREAM
size to tune where the sweep measures HBM.

``--device cpu`` exits non-zero before timing anything: the plain
versions have no tile, and the cache refuses to persist their timings
(the reference's ``--time-pallas`` without ``--no-interpret`` does the
same).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..kernels import registry
from ..tuning import TuningCache, env_fingerprint, tune_op
from .common import emit

DEFAULT_OUT = os.path.join("build", "runs_torch", "tuned.json")


def _rows_for(entry) -> dict:
    params = ";".join(f"{k}={v}" for k, v in sorted(entry.params.items()))
    delta = (entry.default_us - entry.best_us) / entry.default_us * 100 \
        if entry.default_us > 0 else 0.0
    return {
        "name": f"tune/{entry.kernel}/{entry.engine}/{entry.dtype}",
        "us_per_call": f"{entry.best_us:.1f}",
        "derived": (f"{params};default_us={entry.default_us:.1f};"
                    f"delta={delta:+.1f}%;size={entry.size};"
                    f"source={entry.source}"),
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.bench tune",
        description=__doc__.splitlines()[0])
    p.add_argument("--kernel", default=None,
                   help="one kernel family (default: every tunable family)")
    p.add_argument("--budget", type=int, default=8,
                   help="max candidates timed per (kernel, engine, dtype) "
                        "(default 8)")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="tuned cache path; an existing file is merged "
                        f"(default {DEFAULT_OUT})")
    p.add_argument("--size", type=int, default=None,
                   help="input size to time at (default: the family's "
                        "largest bench size)")
    p.add_argument("--dtype", default=None,
                   help="restrict to one dtype (default: the family's "
                        "advertised dtypes)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the inputs' RNG (default 0)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where candidates are timed: the card (default); "
                        "'cpu' is refused, since the plain versions time "
                        "no tile")
    args = p.parse_args(argv)

    if args.device == "cpu":
        # statically invalid: the cache would refuse the entries anyway,
        # so fail before spending time on candidates
        raise SystemExit(
            "error: tune --device cpu would time the kernels' plain "
            "versions, which have no tile; tile choices based on them are "
            "refused at persist. Run on the card.")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no card (torch.cuda.is_available() is false): "
                         "tune times the hand-written kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.kernel is not None:
        try:
            ops = [registry.get(args.kernel)]
        except KeyError as exc:
            raise SystemExit(str(exc))
    else:
        ops = list(registry.all_ops())

    from .bench_kernels import default_hw
    hw_model = default_hw("cuda").name
    # fresh results carry the environment they were timed in, so a merge
    # into an older file re-stamps the fingerprint
    cache = TuningCache(fingerprint=env_fingerprint())
    rows, skipped = [], []
    for op in ops:
        if not op.tile_space:
            skipped.append(op.name)
            continue
        dtypes = (args.dtype,) if args.dtype else op.dtypes
        for engine in sorted(op.engines):
            for dtype in dtypes:
                entry = tune_op(
                    op, engine=engine, dtype=dtype, size=args.size,
                    budget=args.budget, hw_model=hw_model, seed=args.seed)
                cache.add(entry)
                rows.append(_rows_for(entry))
    if not rows:
        raise SystemExit(
            f"no tunable kernels matched (skipped: {skipped or 'none'}); "
            "families opt in by declaring a tile_space")

    if os.path.exists(args.out):
        existing = TuningCache.load_or_warn(args.out)
        existing.merge(cache)
        cache = existing
    path = cache.save(args.out)

    print("name,us_per_call,derived")
    emit(rows)
    for name in skipped:
        print(f"note: {name} declares no tile space; skipped",
              file=sys.stderr)
    print(f"wrote {path} ({len(cache)} entries)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
