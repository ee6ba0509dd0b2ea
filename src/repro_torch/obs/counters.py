"""Roofline counters: the paper's accounting attached to live launches.

Every traced launch gets one :class:`RooflineSample` derived from the
family's Eq. 2 :class:`~repro_torch.core.intensity.KernelTraits` and the
measured microseconds:

* ``achieved_gbs`` -- modeled traffic / measured time: the bandwidth the
  launch realized against the bytes Eq. 2 says it must move.
* ``pct_of_bound`` -- achieved bandwidth as a percentage of the
  platform's ``mem_bw``: the live Eq. 4 gauge.  It is taken against the
  traits' bytes, which for flash-decode count every cache position, not
  only the ``kv_len`` valid ones the kernel reads; the sweep records the
  bytes the function must move as ``bound_bytes`` beside it.
* ``pct_of_ceiling`` -- achieved FLOP/s as a percentage of the Eq. 3
  attainable ceiling ``min(P_engine, B_mem * I)`` for the engine that
  ran: for memory-bound intensities the bandwidth slope for *both*
  engines, the per-launch restatement of Eq. 23/24.

The claims layer checks *consistency* (the recorded sample must
re-derive from the record's own traffic, time and hardware model), not
magnitude.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict

if TYPE_CHECKING:  # pragma: no cover - annotation-only
    from ..core.hw import HardwareSpec

__all__ = ["RooflineSample", "roofline_sample"]


@dataclasses.dataclass(frozen=True)
class RooflineSample:
    """One launch's roofline accounting (see module docstring)."""

    kernel: str
    engine: str
    dtype: str
    traffic_bytes: float
    work_flops: float
    intensity: float
    measured_us: float
    achieved_gbs: float
    achieved_gflops: float
    pct_of_bound: float
    pct_of_ceiling: float

    def as_attrs(self) -> Dict[str, Any]:
        """Span-attr / record-payload form (rounded like the export)."""
        return {
            "traffic_bytes": float(self.traffic_bytes),
            "work_flops": float(self.work_flops),
            "measured_us": round(self.measured_us, 3),
            "achieved_gbs": round(self.achieved_gbs, 4),
            "pct_of_bound": round(self.pct_of_bound, 4),
            "pct_of_ceiling": round(self.pct_of_ceiling, 4),
        }


def roofline_sample(traits, hw: "HardwareSpec", engine: str, dtype: str,
                    measured_us: float) -> RooflineSample:
    """Counters for one launch: *traits* (Eq. 2 W/Q), the platform,
    the engine that actually ran, and the measured microseconds."""
    # lazy import: core.dispatch imports this module, so a module-level
    # import of core would cycle when obs is the entry package
    # (``python -m repro_torch.obs.trace``)
    from ..core.roofline import attainable

    traffic = float(traits.traffic_bytes)
    work = float(traits.work_flops)
    intensity = float(traits.intensity)
    if measured_us > 0:
        seconds = measured_us * 1e-6
        achieved_bps = traffic / seconds
        achieved_flops = work / seconds
    else:
        achieved_bps = 0.0
        achieved_flops = 0.0
    ceiling = attainable(intensity, hw, engine)
    return RooflineSample(
        kernel=str(traits.name),
        engine=str(engine),
        dtype=str(dtype),
        traffic_bytes=traffic,
        work_flops=work,
        intensity=intensity,
        measured_us=float(measured_us),
        achieved_gbs=achieved_bps / 1e9,
        achieved_gflops=achieved_flops / 1e9,
        pct_of_bound=100.0 * achieved_bps / hw.mem_bw,
        pct_of_ceiling=(100.0 * achieved_flops / ceiling
                        if ceiling > 0 else 0.0),
    )
