"""Core library: the paper's analysis framework on PyTorch.

Layers:
  hw         -- engine-aware platform specs (A100 / GH200 / H100 / TPU v5e)
  balance    -- machine balance, boundedness (Eq. 1, 4)
  roofline   -- two-ceiling roofline (Eq. 3, Fig. 2)
  intensity  -- per-workload W/Q/I formulas (paper §3)
  bounds     -- matrix-engine speedup bounds (Eq. 17-24)
  advisor    -- engine dispatch policy (paper §6 as code)
  dispatch   -- memoized advisor routing + the shared elementwise wrapper
  timing     -- CUDA-event kernel timing
  analysis   -- a step's roofline terms from its traced cost and the
                collectives it records (the dry run's)
  trace_cost -- FLOP / byte accounting of a step traced on meta tensors
"""
from .advisor import DEFAULT_ADVISOR, Advice, EngineAdvisor
from .analysis import (CollectiveStats, RooflineReport, analyze,
                       collective_stats)
from .balance import is_memory_bound, machine_balance, time_compute, time_memory
from .bounds import (best_case_speedup, break_even_alpha,
                     speedup_bound_intensity, speedup_overlapped,
                     speedup_unoverlapped, tensor_core_upper_bound,
                     workload_upper_bound)
from .dispatch import (DEFAULT_DISPATCHER, Dispatcher, elementwise_call,
                       normalize_engine)
from .hw import (A100_80G, DENSE_PEAKS, GH200, H100_NVL, H100_PCIE, H100_SXM,
                 PLATFORMS, TPU_V5E, HardwareSpec, dense_peak, get_platform,
                 spec_for_device_name)
from .intensity import (KernelTraits, axpy, gemv, paper_table, scale,
                        spmv_bell, spmv_csr, stencil, stencil_matmul,
                        temporal_depth_to_compute_bound, triad)
from .roofline import (RooflinePoint, attainable, operational_intensity,
                       place, roofline_table)
from .timing import Timing, busy_us, device_busy_us, time_fn

__all__ = [n for n in dir() if not n.startswith("_")]
