"""Claims layer: BENCH records -> verified evidence.

1. :mod:`repro_torch.report.records` ingests record files (the
   reference's schemas 1-7, bench and serving, plus the port's optional
   card fields),
2. :mod:`repro_torch.report.claims` joins each bench record back to the
   analytic layer and verifies the paper's claims: the Eq. 17/23/24
   ceiling, §6 routing, per-dtype accuracy, Eq. 4 boundedness, and the
   obs trace's reconciliation with the record.

``python -m repro_torch.bench kernels`` writes the records;
``chip_smoke.py`` writes them on the card and verifies every one.
"""
from .claims import (CLAIMS, SAMPLE_CLOCKS, TOLERANCE, TRACE_CLAIMS,
                     ClaimResult, ceiling_bound, check_record,
                     check_records, hw_for, violations)
from .records import (BenchRecord, RecordSet, ServingRecord, load_dir,
                      load_file)

__all__ = [
    "CLAIMS", "SAMPLE_CLOCKS", "TOLERANCE", "TRACE_CLAIMS", "BenchRecord",
    "ClaimResult", "RecordSet", "ServingRecord", "ceiling_bound",
    "check_record", "check_records", "hw_for", "load_dir", "load_file",
    "violations",
]
