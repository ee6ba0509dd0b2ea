"""Claims layer: BENCH records -> verified evidence.

1. :mod:`repro_torch.report.records` ingests record files (the
   reference's schemas 1-7, bench and serving, plus the port's optional
   card fields),
2. :mod:`repro_torch.report.claims` joins each record back to the
   analytic layer and verifies the paper's claims: for bench records the
   Eq. 17/23/24 ceiling, §6 routing, per-dtype accuracy and Eq. 4
   boundedness; for serving sessions the same analytic claims under load
   plus percentile and goodput consistency and, for lm sessions, the
   model-scale verdict, for online-tuned sessions the ``online_ceiling``
   replay, for chaos sessions ``elastic_integrity``; for mesh sweep
   points the shard claims, and for points measured on ranks the mesh
   claims; and for both the obs trace's reconciliation
   with the record,
3. :mod:`repro_torch.report.render` renders the verified records as
   ``REPORT.md`` and per-kernel pages (``python -m repro_torch.bench
   report``, into ``build/runs_torch/`` by default).

``python -m repro_torch.bench kernels`` and ``... serve`` write the
records; ``chip_smoke.py`` writes them on the card and verifies every
one; ``python -m repro_torch.bench.compare`` gates two record sets.
"""
from .claims import (CLAIMS, ELASTIC_CLAIMS, MESH_CLAIMS, MODEL_CLAIMS,
                     ONLINE_CLAIMS,
                     SAMPLE_CLOCKS, SERVING_CLAIMS, SHARD_CLAIMS, TOLERANCE,
                     TRACE_CLAIMS, ClaimResult, ceiling_bound, check_record,
                     check_records, check_serving_record, hw_for,
                     violations)
from .records import (BenchRecord, RecordSet, ServingRecord, load_dir,
                      load_file)
from .render import (render_kernel_page, render_report, render_serving_page,
                     write_report)

__all__ = [
    "CLAIMS", "ELASTIC_CLAIMS", "MESH_CLAIMS", "MODEL_CLAIMS",
    "ONLINE_CLAIMS",
    "SAMPLE_CLOCKS", "SERVING_CLAIMS", "SHARD_CLAIMS", "TOLERANCE",
    "TRACE_CLAIMS", "BenchRecord",
    "ClaimResult", "RecordSet", "ServingRecord", "ceiling_bound",
    "check_record", "check_records", "check_serving_record", "hw_for",
    "load_dir", "load_file", "render_kernel_page", "render_report",
    "render_serving_page", "violations", "write_report",
]
