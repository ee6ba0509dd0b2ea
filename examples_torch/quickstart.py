"""Quickstart: the paper's decision framework on the port, in five minutes.

1. Place your kernel on the roofline (which engine's knee is it under?).
2. Ask the advisor which engine to use and what the matrix engine could
   ever buy you (Eq. 17-24), for the card the port runs on.
3. Run the same computation on both engines (hand-written CUDA kernels
   on the card; their plain PyTorch versions with ``--device cpu``) and
   confirm they agree: the time difference on the card is bounded by the
   numbers printed in step 2.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import (A100_80G, GH200, H100_SXM, EngineAdvisor,
                              machine_balance, spec_for_device_name,
                              tensor_core_upper_bound)
from repro_torch.core.intensity import gemv, scale, spmv_csr, stencil
from repro_torch.kernels.scale.ops import scale as scale_op
from repro_torch.kernels.scale.ref import scale_ref


def card_spec(device: str):
    """The HardwareSpec of the card (H100 SXM5 for ``--device cpu``)."""
    if device == "cuda":
        return spec_for_device_name(torch.cuda.get_device_name(0))
    return H100_SXM


def main(argv=None):
    """Print the three steps; returns each engine's max error."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    spec = card_spec(args.device)
    backend = "cuda" if args.device == "cuda" else "plain"

    print("=== 1. machine balance (paper Eq. 1) ===")
    for hw in (A100_80G, GH200, spec):
        print(f"  {hw.name:10s}  B_vector={machine_balance(hw, 'vector'):7.2f} "
              f"flop/B   B_matrix={machine_balance(hw, 'matrix'):7.2f} flop/B  "
              f"alpha={hw.alpha:.1f}")

    print("\n=== 2. the advisor (paper §6 as code) ===")
    advisor = EngineAdvisor(spec)
    for traits in (scale(1 << 20, 4), gemv(8192, 8192, 4),
                   spmv_csr(8192, 8192, 9 * 8192, 4),
                   stencil(5, 1, 4), stencil(5, 64, 4)):
        print(" ", advisor.advise(traits))
    print(f"  FP64-GPU ceiling (alpha=2): "
          f"{tensor_core_upper_bound(2.0):.3f}x  <- the paper's 1.33x")

    print(f"\n=== 3. both engines, same answer ({backend}) ===")
    gen = torch.Generator().manual_seed(0)
    b = torch.randn(100_000, generator=gen).to(args.device)
    want = scale_ref(b, 2.5)
    errs = {}
    for eng in ("vector", "matrix"):
        got = scale_op(b, 2.5, engine=eng, backend=backend)
        errs[f"scale/{eng}"] = float((got - want).abs().max())
        print(f"  scale[{eng}] max err vs oracle: {errs[f'scale/{eng}']:.2e}")
    print("\nSame memory path, same result; the matrix engine cannot beat "
          "the bandwidth wall.")
    return errs


if __name__ == "__main__":
    main()
