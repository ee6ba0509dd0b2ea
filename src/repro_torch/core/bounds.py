"""Speedup bounds for matrix engines on memory-bound kernels (paper §4).

Two extremes:
  fully overlapped   (Eq. 17): T = max(T_mem, T_others)  -> speedup = 1
  fully un-overlapped(Eq. 18): T = T_cmp + T_mem + T_others

For the un-overlapped case with matrix-engine speedup alpha:
  speedup = 1 + (alpha - 1) / (1 + alpha * (T_mem + T_others) / T_cmp)  (Eq. 20)
          < 1 + (alpha - 1) / (1 + alpha * B / I)                       (Eq. 22)
          < 2 - 2 / (1 + alpha)            [T_cmp -> T_mem]            (Eq. 23)
          < 1 + I / B                      [alpha -> inf]               (Eq. 24)
"""
from __future__ import annotations

import math

from .balance import machine_balance
from .hw import HardwareSpec


def speedup_unoverlapped(alpha: float, t_cmp_cc: float, t_mem: float,
                         t_others: float = 0.0) -> float:
    """Exact un-overlapped speedup, paper Eq. 19/20."""
    if alpha <= 1:
        raise ValueError("alpha must exceed 1")
    return (t_cmp_cc + t_mem + t_others) / (t_cmp_cc / alpha + t_mem + t_others)


def speedup_bound_intensity(alpha: float, intensity: float,
                            balance: float) -> float:
    """Paper Eq. 22: bound from I and B (T_others >= 0 dropped)."""
    return 1.0 + (alpha - 1.0) / (1.0 + alpha * balance / intensity)


def tensor_core_upper_bound(alpha: float) -> float:
    """Paper Eq. 23: the memory-bound ceiling 2 - 2/(1+alpha).

    alpha=2 (FP64 GPUs) -> 4/3 ~= 1.33; alpha->inf -> 2.
    """
    return 2.0 - 2.0 / (1.0 + alpha)


def workload_upper_bound(intensity: float, balance: float) -> float:
    """Paper Eq. 24: alpha->inf bound 1 + I/B."""
    return 1.0 + intensity / balance


def speedup_overlapped() -> float:
    """Paper Eq. 17: fully overlapped memory-bound kernels gain nothing."""
    return 1.0


def best_case_speedup(hw: HardwareSpec, intensity: float) -> float:
    """The tightest applicable bound for a platform x kernel pair.

    min(Eq. 23 with the platform's alpha, Eq. 24 with its balance).  Real
    kernels sit between 1x (overlapped) and this.
    """
    b = machine_balance(hw, "vector")
    bounds = [
        tensor_core_upper_bound(hw.alpha),
        workload_upper_bound(intensity, b),
        speedup_bound_intensity(hw.alpha, intensity, b),
    ]
    return min(bounds)


def break_even_alpha(speedup_target: float) -> float:
    """Invert Eq. 23: the alpha needed for a target memory-bound speedup."""
    if not 1.0 <= speedup_target < 2.0:
        return math.inf
    return (speedup_target) / (2.0 - speedup_target)
