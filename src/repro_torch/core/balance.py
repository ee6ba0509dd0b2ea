"""Machine balance and boundedness classification (paper §2.2, §2.5)."""
from __future__ import annotations

from .hw import HardwareSpec


def machine_balance(hw: HardwareSpec, engine: str = "matrix") -> float:
    """B = P / B_mem  [flop/byte]  (paper Eq. 1).

    The paper computes balance against whichever engine is under discussion;
    the roofline inflection point (Fig. 2) uses the top ceiling.
    """
    return hw.engine(engine).peak_flops / hw.mem_bw


def is_memory_bound(intensity: float, hw: HardwareSpec,
                    engine: str = "matrix") -> bool:
    """Paper Eq. 4: memory-bound iff I < B."""
    return intensity < machine_balance(hw, engine)


def time_compute(work_flops: float, hw: HardwareSpec,
                 engine: str = "matrix") -> float:
    """T_cmp = W / P (paper §4)."""
    return work_flops / hw.engine(engine).peak_flops


def time_memory(traffic_bytes: float, hw: HardwareSpec) -> float:
    """T_mem = Q / B (paper §4)."""
    return traffic_bytes / hw.mem_bw
