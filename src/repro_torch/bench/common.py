"""Shared benchmark utilities: CSV rows, JSON record files, environment.

Record files written here are the input to the claims layer
(``repro_torch.report``) and the compare gate
(``repro_torch.bench.compare``): schema-versioned ``BENCH_<kernel>.json``
sweeps and ``BENCH_serve_<kernel>.json`` serving sessions, with
environment metadata.
"""
from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
from typing import List, Optional, TextIO

import torch

# one implementation for the sweep and every other timing consumer
from ..core.timing import Timing, time_fn

__all__ = ["SCHEMA_VERSION", "SERVING_SCHEMA_VERSION", "Timing",
           "bench_env", "card_line", "emit", "time_fn", "write_json",
           "write_serving_json"]

#: Version of the BENCH_<kernel>.json file format: the reference's schema
#: 7 (schema 2 wraps records with environment metadata, 3 adds
#: ``tile_config``, 5 the mesh fields, 6 ``mesh_exec``, 7 the obs
#: ``trace`` block).  The port's records add optional fields that a
#: schema-7 reader ignores (``us_per_call``, ``profiler_device_us``,
#: ``bound_bytes``, ``l2_resident``, ``pred_us``).
SCHEMA_VERSION = 7

#: Version of the serving record file format (``BENCH_serve_*.json``):
#: the reference's schema 5, a ``"kind": "serving"`` set of session
#: summaries from ``repro_torch.serving.metrics.serving_record`` with the
#: per-record ``trace`` block (serving files are told apart from bench
#: schema 5 by their ``kind`` marker, not the number).
SERVING_SCHEMA_VERSION = 5


def emit(rows: List[dict], out: Optional[TextIO] = None) -> None:
    """Write ``name,us_per_call,derived`` CSV rows (RFC-4180 quoted)."""
    writer = csv.writer(out if out is not None else sys.stdout,
                        lineterminator="\n")
    for r in rows:
        writer.writerow([r["name"], r.get("us_per_call", ""),
                         r.get("derived", "")])


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi gave nothing"


def bench_env(device: str, hw_model: str) -> dict:
    """Environment metadata recorded alongside every record set.

    ``device`` is where the sweep ran: ``"cuda"`` (recorded as ``"gpu"``,
    with the card's name and power limit) or ``"cpu"``.
    """
    import numpy

    on_card = device == "cuda"
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": numpy.__version__,
        "device": "gpu" if on_card else "cpu",
        "card": torch.cuda.get_device_name(0) if on_card else None,
        "card_power": card_line() if on_card else None,
        "hw_model": hw_model,
    }


def _write_record_file(filename: str, kernel: str, schema: int,
                       records: List[dict], out_dir: str, env: dict,
                       extra: Optional[dict] = None) -> str:
    """The one serialization convention every record file shares."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    payload = {"schema": schema, "kernel": kernel, "env": env,
               "records": records, **(extra or {})}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def write_json(kernel: str, records: List[dict], out_dir: str,
               env: dict, mesh: int = 1) -> str:
    """Write one kernel's sweep records to ``out_dir/BENCH_<kernel>.json``.

    ``{"schema": 7, "kernel": ..., "env": {...}, "records": [...]}`` with
    one record per (engine, size, dtype) sweep point, sorted keys.  Mesh
    sweeps (``mesh > 1``) land in ``BENCH_<kernel>_mesh<N>.json`` beside
    the single-device records instead of clobbering them.
    """
    name = (f"BENCH_{kernel}.json" if mesh <= 1
            else f"BENCH_{kernel}_mesh{mesh}.json")
    return _write_record_file(name, kernel, SCHEMA_VERSION, records,
                              out_dir, env)


def write_serving_json(kernel: str, records: List[dict], out_dir: str,
                       env: dict, suffix: str = "", mesh: int = 1) -> str:
    """Write one kernel's serving sessions to
    ``out_dir/BENCH_serve_<kernel><suffix>.json``.

    ``{"schema": 5, "kind": "serving", "kernel": ..., "env": {...},
    "records": [...]}`` with one record per (engine, workload, size,
    dtype) session, consumed by ``repro_torch.report`` and gated on
    p99/goodput by ``repro_torch.bench.compare``.  *suffix* (``"_online"``
    for ``serve --online-tune`` sessions) keeps a session variant beside
    the baseline instead of clobbering it; mesh sessions (``mesh > 1``)
    land in ``BENCH_serve_<kernel><suffix>_mesh<N>.json`` the same way.
    """
    name = (f"BENCH_serve_{kernel}{suffix}.json" if mesh <= 1
            else f"BENCH_serve_{kernel}{suffix}_mesh{mesh}.json")
    return _write_record_file(name, kernel, SERVING_SCHEMA_VERSION,
                              records, out_dir, env,
                              extra={"kind": "serving"})
