"""``itl_p95_ms``: the 95th percentile (nearest rank), over every step of
the window, of the gap between consecutive steps' tokens being ready,
from the CUDA events recorded after each step's argmax (the first gap
from an event at the window's start)."""
from perfbench.harness.core import percentile


def read(run):
    gaps = run.record.get("itl_ms")
    return percentile(gaps, 95) if gaps else None
