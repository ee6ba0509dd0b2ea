"""Engine advisor: the paper's decision framework as a dispatch policy.

Paper §6 (key takeaways) distilled into code:
  1. classify the kernel (I vs per-engine machine balance),
  2. memory-bound  -> vector engine (simplicity + it cannot lose),
  3. compute-bound -> matrix engine,
  4. always report the theoretical ceiling so callers can see *why*.

The kernel families in ``repro_torch.kernels`` consult this to pick
between their CUDA-core and tensor-core kernels (``engine='auto'``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from .balance import machine_balance
from .bounds import best_case_speedup, speedup_overlapped
from .hw import H100_SXM, HardwareSpec
from .intensity import KernelTraits


@dataclasses.dataclass(frozen=True)
class Advice:
    """One §6 decision: engine, boundedness and the Eq. 23/24 ceiling."""

    kernel: str
    engine: str                 # "matrix" | "vector"
    memory_bound: bool
    intensity: float
    balance_vector: float
    balance_matrix: float
    max_speedup_matrix: float   # tightest paper bound if the matrix engine ran
    reason: str
    # tile config the dispatch layer applies for this decision, as a
    # hashable sorted (name, value) tuple; None = static defaults (the
    # port has no tuning cache yet, so it stays None)
    tile_config: Optional[Tuple[Tuple[str, int], ...]] = None
    # how a mesh-configured dispatcher would split this call; None =
    # single-device dispatch (the port has no mesh yet)
    shard_spec: Optional[Any] = None
    # how a sharded call executes; meaningless while shard_spec is None
    exec_mode: str = "virtual"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (f"[{self.kernel}] I={self.intensity:.4g} -> {self.engine} "
                f"({self.reason}; matrix-engine ceiling "
                f"{self.max_speedup_matrix:.3f}x)")


class EngineAdvisor:
    """Route ops to the matrix or vector engine by roofline position."""

    def __init__(self, hw: HardwareSpec = H100_SXM,
                 overlap_assumption: float = 1.0):
        """overlap_assumption in [0,1]: 1.0 = fully overlapped (paper §4.1,
        matrix engine gains nothing); 0.0 = fully un-overlapped (Eq. 23/24
        apply).
        """
        self.hw = hw
        self.overlap = overlap_assumption

    def advise(self, traits: KernelTraits) -> Advice:
        """Classify one kernel (Eq. 4) and pick its engine (§6)."""
        i = traits.intensity
        b_vec = machine_balance(self.hw, "vector")
        b_mat = machine_balance(self.hw, "matrix")
        memory_bound = i < b_vec  # below even the vector knee

        if memory_bound:
            ceiling = (speedup_overlapped() if self.overlap >= 1.0
                       else best_case_speedup(self.hw, i))
            engine = "vector"
            reason = "memory-bound: I < B_vector; matrix engine cannot help"
        elif i < b_mat:
            engine = "matrix"
            ceiling = best_case_speedup(self.hw, i)
            reason = "vector-compute-bound: matrix engine raises the ceiling"
        else:
            engine = "matrix"
            ceiling = self.hw.alpha
            reason = "compute-bound: matrix engine is the right tool"
        return Advice(
            kernel=traits.name, engine=engine, memory_bound=memory_bound,
            intensity=i, balance_vector=b_vec, balance_matrix=b_mat,
            max_speedup_matrix=ceiling, reason=reason)


DEFAULT_ADVISOR = EngineAdvisor()
