"""Paper Table 1 + §4 bounds: machine balance and matrix-engine speedup
ceilings per platform (A100 / GH200 / the H100 parts / TPU v5e), plus
the Eq. 14 temporal-blocking threshold.  Pure analytics."""
from __future__ import annotations

from ..core import (PLATFORMS, best_case_speedup, gemv, machine_balance,
                    scale, spmv_csr, stencil, temporal_depth_to_compute_bound,
                    tensor_core_upper_bound, workload_upper_bound)
from .common import emit


def rows():
    """CSV rows: balance, Eq. 23 ceiling and per-kernel best case per
    platform, then the paper's Eq. 14 and Eq. 24 examples."""
    out = []
    for key, hw in PLATFORMS.items():
        bal_v = machine_balance(hw, "vector")
        bal_m = machine_balance(hw, "matrix")
        out.append({
            "name": f"bounds/{key}/machine_balance",
            "us_per_call": "",
            "derived": (f"alpha={hw.alpha:.1f};B_vec={bal_v:.2f};"
                        f"B_mat={bal_m:.2f}"),
        })
        out.append({
            "name": f"bounds/{key}/eq23_engine_ceiling",
            "us_per_call": "",
            "derived": f"{tensor_core_upper_bound(hw.alpha):.4f}x",
        })
        dsize = 8 if key != "v5e" else 4
        for t in (scale(1, dsize), gemv(8192, 8192, dsize),
                  spmv_csr(8192, 8192, 9 * 8192, dsize), stencil(5, 1, dsize)):
            out.append({
                "name": f"bounds/{key}/{t.name}/best_case_speedup",
                "us_per_call": "",
                "derived": (f"I={t.intensity:.4f};"
                            f"bound={best_case_speedup(hw, t.intensity):.4f}x"),
            })
    # Eq. 14 with the paper's quoted GH200 balance
    out.append({
        "name": "bounds/gh200/eq14_temporal_depth_2d5pt",
        "us_per_call": "",
        "derived": f"t>{temporal_depth_to_compute_bound(5, 9.99, 8):.2f}",
    })
    # workload bound examples from the paper text
    a100_b = machine_balance(PLATFORMS["a100"], "vector")
    out.append({
        "name": "bounds/a100/eq24_gemv",
        "us_per_call": "",
        "derived": f"{workload_upper_bound(0.25, a100_b):.4f}x (paper: <1.05)",
    })
    return out


def main():
    emit(rows())


if __name__ == "__main__":
    main()
