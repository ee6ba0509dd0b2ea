"""The paper's empirical comparison end to end on the port: SCALE, SpMV
and the stencil suite, each on both engines, with the theory bound
printed beside the result, then STREAM Triad and AXPY from the registry.

On the card every call launches a hand-written kernel (K1 for SCALE,
Triad and AXPY, K2 for SpMV, K3 for the stencils); ``--device cpu`` runs
their plain PyTorch versions.

Run:  PYTHONPATH=src python examples_torch/kernel_showdown.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (DEFAULT_ADVISOR, H100_SXM, best_case_speedup,
                              spec_for_device_name)
from repro_torch.core.intensity import scale as scale_traits
from repro_torch.core.intensity import spmv_bell, stencil as stencil_traits
from repro_torch.kernels import registry
from repro_torch.kernels.scale.ops import scale
from repro_torch.kernels.scale.ref import scale_ref
from repro_torch.kernels.spmv.ops import dense_to_bell, spmv
from repro_torch.kernels.stencil.defs import TABLE3_DEPTH, suite
from repro_torch.kernels.stencil.ops import stencil
from repro_torch.kernels.stencil.ref import stencil_ref


def card_spec(device: str):
    """The HardwareSpec of the card (H100 SXM5 for ``--device cpu``)."""
    if device == "cuda":
        return spec_for_device_name(torch.cuda.get_device_name(0))
    return H100_SXM


def banner(s):
    print(f"\n=== {s} ===")


def main(argv=None):
    """Run the showdown; returns each (kernel, engine)'s max error."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev, spec = args.device, card_spec(args.device)
    backend = "cuda" if dev == "cuda" else "plain"
    rng = np.random.default_rng(0)
    errs = {}

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    banner("SCALE (paper Fig. 6)")
    b = t(rng.standard_normal(1 << 18))
    want = scale_ref(b, 3.0)
    for eng in ("vector", "matrix", "auto"):
        got = scale(b, 3.0, engine=eng, backend=backend)
        errs[f"scale/{eng}"] = float((got - want).abs().max())
        print(f"  engine={eng:6s} max_err={errs[f'scale/{eng}']:.2e}")
    print(f"  advisor: {DEFAULT_ADVISOR.advise(scale_traits(b.numel(), 4))}")

    banner("SpMV on block-ELL (paper Fig. 7)")
    a = rng.standard_normal((256, 1024)).astype(np.float32)
    a *= rng.random((256, 1024)) < 0.05
    bell = dense_to_bell(t(a), bm=8, bn=128)
    xn = rng.standard_normal(1024).astype(np.float32)
    want = a.astype(np.float64) @ xn.astype(np.float64)
    for eng in ("vector", "matrix"):
        got = spmv(bell, t(xn), engine=eng, backend=backend).cpu().numpy()
        errs[f"spmv/{eng}"] = float(np.max(np.abs(got - want)))
        print(f"  engine={eng:6s} max_err={errs[f'spmv/{eng}']:.2e}")
    nbr, mb, bm, bn = bell.blocks.shape
    tr = spmv_bell(256, 1024, nbr * mb, bm, bn, 4)
    print(f"  the matrix engine's matvec uses 1/8 of each B fragment; "
          f"ceiling anyway = {best_case_speedup(spec, tr.intensity):.4f}x")

    banner("Stencil suite (paper Fig. 8, Table-3 depths)")
    for name, sp in suite().items():
        depth = TABLE3_DEPTH[name]
        shape = (128, 128) if sp.ndim == 2 else (24, 24, 24)
        u = t(rng.standard_normal(shape))
        want = stencil_ref(u, sp, steps=depth)
        row = []
        for eng in ("vector", "matrix"):
            got = stencil(u, sp, steps=depth, engine=eng, block_rows=8,
                          backend=backend)
            errs[f"{name}/{eng}"] = float((got - want).abs().max())
            row.append(errs[f"{name}/{eng}"])
        tr = stencil_traits(sp.num_points, t=depth, dsize=4)
        adv = DEFAULT_ADVISOR.advise(tr)
        print(f"  {name:7s} t={depth}  err_vector={row[0]:.1e} "
              f"err_matrix={row[1]:.1e}  I_t={tr.intensity:.2f} -> {adv.engine}")

    banner("STREAM Triad + AXPY (registry-discovered)")
    for name in ("triad", "axpy"):
        op = registry.get(name)
        args_, kw = op.make_inputs(rng, 1 << 18, "float32", dev)
        want = op.reference(*args_, **kw).float()
        for eng in ("vector", "matrix"):
            got = op(*args_, engine=eng, backend=backend, **kw).float()
            errs[f"{name}/{eng}"] = float((got - want).abs().max())
            print(f"  {name}/{eng}  max_err={errs[f'{name}/{eng}']:.2e}")
        print(f"  advisor: {op.advice(*args_, **kw)}")

    print("\nConclusion (matches the paper): every memory-bound kernel "
          "routes to the vector engine; the matrix-engine ceiling is "
          f"{best_case_speedup(spec, 0.25):.4f}x at I = 1/4.")
    return errs


if __name__ == "__main__":
    main()
