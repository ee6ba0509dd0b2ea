"""Roofline model (paper §2.3, §2.4) with per-engine ceilings."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .hw import HardwareSpec


def operational_intensity(work_flops: float, traffic_bytes: float) -> float:
    """I = W / Q  (paper Eq. 2)."""
    if traffic_bytes <= 0:
        raise ValueError("traffic must be positive")
    return work_flops / traffic_bytes


def attainable(intensity: float, hw: HardwareSpec,
               engine: str = "matrix") -> float:
    """P_attainable = min(P, B * I)  (paper Eq. 3).

    Tensor cores appear as an additional ceiling *above* the vector-engine
    ceiling (paper §2.4) because both engines share the memory path — so the
    bandwidth slope B*I is engine-independent.
    """
    return min(hw.engine(engine).peak_flops, hw.mem_bw * intensity)


@dataclasses.dataclass(frozen=True)
class RooflinePoint:
    kernel: str
    intensity: float                 # flop/byte
    attainable_vector: float         # FLOP/s under the vector ceiling
    attainable_matrix: float         # FLOP/s under the matrix ceiling
    memory_bound_vector: bool
    memory_bound_matrix: bool


def place(kernel: str, intensity: float, hw: HardwareSpec) -> RooflinePoint:
    """Place a kernel on the two-ceiling roofline of a platform (Fig. 2)."""
    from .balance import machine_balance
    return RooflinePoint(
        kernel=kernel,
        intensity=intensity,
        attainable_vector=attainable(intensity, hw, "vector"),
        attainable_matrix=attainable(intensity, hw, "matrix"),
        memory_bound_vector=intensity < machine_balance(hw, "vector"),
        memory_bound_matrix=intensity < machine_balance(hw, "matrix"),
    )


def roofline_table(points: Dict[str, float], hw: HardwareSpec
                   ) -> List[RooflinePoint]:
    return [place(k, i, hw) for k, i in sorted(points.items())]
