"""Observability: two-clock tracing, roofline counters, metrics and
structured logging for the port's layers.

* :mod:`repro_torch.obs.trace` -- span tracer on two clocks with
  byte-deterministic Chrome-trace export and a
  ``python -m repro_torch.obs.trace`` validator; while a
  ``torch.profiler`` records, its spans are also the profiler's ranges.
* :mod:`repro_torch.obs.counters` -- per-launch roofline counters:
  modeled bytes (Eq. 2 traits), measured us, achieved GB/s, percent of
  the Eq. 4 bandwidth bound and of the Eq. 3/23/24 attainable ceiling.
* :mod:`repro_torch.obs.metrics` -- counters, gauges and histograms with
  numpy percentile semantics.
* :mod:`repro_torch.obs.log` -- the leveled structured logger.
* :mod:`repro_torch.obs.record` -- device-side counters a step leaves on
  the card (the expert share's routed rows), read once after a reader's
  synchronisation.

Bench records carry a ``trace`` reconciliation block, and
``repro_torch.report.claims`` proves that the span medians match the
recorded time (the ``trace_reconciliation`` claim).
"""
from .counters import RooflineSample, roofline_sample
from .log import LEVELS, LOG, LogRecord, StructuredLogger
from .metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .trace import (TRACER, SpanEvent, TraceView, Tracer, capture,
                    chrome_trace, dump_chrome_trace, read_chrome_trace,
                    validate_chrome_trace, write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "LEVELS", "LOG", "LogRecord",
    "MetricsRegistry", "REGISTRY", "RooflineSample", "SpanEvent",
    "StructuredLogger", "TRACER", "TraceView", "Tracer", "capture",
    "chrome_trace", "dump_chrome_trace", "read_chrome_trace",
    "roofline_sample", "validate_chrome_trace", "write_chrome_trace",
]
