#!/usr/bin/env python3
"""Drive the PyTorch / H100 port's main path on one NVIDIA card.

The paper's experiment end to end, through the port's public entry
points: every §3 kernel family (SCALE, STREAM Triad, AXPY, block-ELL
SpMV, Table-3 stencils) is classified by the §6 advisor, launched on the
CUDA-core (vector) and the tensor-core (matrix) kernel, timed with CUDA
events, and its measured matrix/vector time ratio printed beside the
Eq. 23 ceiling.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device line (nvidia-smi name and power limit, HardwareSpec chosen);
  2. build of the hand-written kernels from src/repro_torch/kernels/csrc;
  3. each kernel against its plain PyTorch version on the card at small
     and odd shapes (float32 max-abs <= 1e-4, bfloat16 within one ulp);
  4. the experiment at STREAM size (every array >= 4x the 50 MiB L2):
     launch counts reset before it and read after it, one JSON line per
     point and engine, then each output held against its plain version;
  5. one JSON line of per-kernel numbers, then the result line.

Exits non-zero, printing no result, without a card or without the
repository's sources beside this file.
"""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
WARMUP, ITERS = 3, 20
F32_TOL = 1e-4            # report/claims.py's float32 accuracy claim
#: Non-tensor float32 peak of an H100 SXM (NVIDIA datasheet), for the
#: operations side of each kernel's bound.
PEAK_OPS = 67e12

#: (kernel family, engine) -> the TPU kernel it replaces (the function that
#: reaches pl.pallas_call) and the CUDA source.
REPLACES = {
    "scale": "src/repro/core/dispatch.py:473",
    "triad": "src/repro/core/dispatch.py:473",
    "axpy": "src/repro/core/dispatch.py:473",
    "spmv": "src/repro/kernels/spmv/spmv.py:59",
    "stencil": "src/repro/kernels/stencil/stencil.py:135",
}
SOURCE = {
    "scale": "elementwise", "triad": "elementwise", "axpy": "elementwise",
    "spmv": "spmv", "stencil": "stencil",
}


class SmokeFailure(RuntimeError):
    pass


def _setup():
    try:
        import torch
    except ImportError as exc:
        raise SmokeFailure(f"PyTorch is not installed: {exc}") from None
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SmokeFailure(f"no src/repro_torch beside {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    return torch


def main() -> int:
    try:
        torch = _setup()
    except SmokeFailure as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.carry import cast
    from repro_torch.core.bounds import tensor_core_upper_bound
    from repro_torch.core.dispatch import elementwise_call, elementwise_plain
    from repro_torch.core.hw import spec_for_device_name
    from repro_torch.core.timing import time_fn
    from repro_torch.kernels import _ext, registry
    from repro_torch.kernels.spmv.ref import dense_to_bell
    from repro_torch.kernels.spmv.spmv import spmv_plain
    from repro_torch.kernels.stencil.defs import TABLE3_DEPTH, suite
    from repro_torch.kernels.stencil.stencil import stencil_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card)
    kind = torch.cuda.get_device_name(0)
    hw = spec_for_device_name(kind)
    ceiling = tensor_core_upper_bound(hw.alpha)
    print(f"device: {kind}; HardwareSpec {hw.name} (datasheet "
          f"{hw.mem_bw / 1e12:.2f} TB/s, alpha {hw.alpha:.4f}, "
          f"Eq. 23 ceiling {ceiling:.4f})", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _ext.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_ext.SOURCES)})", flush=True)

    def plain_of(name, args, kw, engine):
        """The plain PyTorch version of an op's kernel, on the same inputs."""
        if name == "scale":
            b, q = args
            return elementwise_plain(b, q, None, engine)
        if name == "triad":
            b, c, q = args
            return elementwise_plain(c, q, b, engine)
        if name == "axpy":
            a, x, y = args
            return elementwise_plain(x, a, y, engine)
        if name == "spmv":
            bell, x = args
            y = spmv_plain(bell.blocks, bell.cols, x, engine=engine)
            return y.reshape(-1)[:bell.shape[0]]
        u, spec = args
        return stencil_plain(u, spec, steps=kw["steps"], engine=engine)

    def err_and_tol(got, want, tol_f32):
        err = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
        if got.dtype == torch.bfloat16:
            mag = want.float().abs().clamp_min(1e-30)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            ok = bool(((got.float() - want.float()).abs() <= ulp).all())
        else:
            ok = err <= tol_f32
        return err, ok and got.shape == want.shape and got.dtype == want.dtype

    def check(tag, got, want, tol_f32=F32_TOL):
        torch.cuda.synchronize()
        err, ok = err_and_tol(got, want, tol_f32)
        if not ok:
            failures.append(f"{tag}: max_abs_err {err}")
        return err

    # tensor-core instructions in the built SASS: every matrix kernel
    # issues DMMA/HMMA, no vector kernel does
    sass = {}
    for symbol, ops in _ext.mma_instructions().items():
        match = re.search(r"(elementwise|spmv|stencil)_(?:(vector|matrix)_)?"
                          r"kernel(?:ILb[01]ELb[01]ELb([01])E|ILb([01])E)?",
                          symbol)
        if match is None:
            continue
        family, named, ew_mma, st_mma = match.groups()
        matrix = named == "matrix" or "1" in (ew_mma, st_mma)
        mma = ops["DMMA"] + ops["HMMA"]
        key = f"{family}/{'matrix' if matrix else 'vector'}"
        sass.setdefault(key, {"kernels": 0, "DMMA": 0, "HMMA": 0})
        sass[key]["kernels"] += 1
        sass[key]["DMMA"] += ops["DMMA"]
        sass[key]["HMMA"] += ops["HMMA"]
        if (mma == 0) == matrix:
            failures.append(f"SASS of {symbol}: {ops} tensor-core "
                            f"instructions in a {key} kernel")
    print(json.dumps({"sass_mma": sass}), flush=True)
    if len(sass) != 6:
        failures.append(f"SASS audit found {sorted(sass)}, expected the six "
                        f"family/engine kernels")

    # -- 3. kernels against their plain versions on the card ---------------
    n_checks = 0
    for op in registry.all_ops():
        for dtype in op.dtypes:
            args, kw = op.make_inputs(np.random.default_rng(SEED),
                                      op.test_size, dtype)
            for engine in ("vector", "matrix"):
                check(f"{op.name}/{engine}/{dtype}@test_size",
                      op(*args, engine=engine, **kw),
                      plain_of(op.name, args, kw, engine))
                n_checks += 1
            advice = op.advice(*args, **kw)
            before = _ext.LAUNCHES[f"{op.name}_vector"]
            op(*args, engine="auto", **kw)
            if advice.engine != "vector" or \
                    _ext.LAUNCHES[f"{op.name}_vector"] != before + 1:
                failures.append(f"{op.name}/{dtype}: engine='auto' did not "
                                f"route to the vector kernel")
    gen = torch.Generator().manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((17,), (300_000,), (33, 95)):
            m = torch.randn(shape, generator=gen).to(dtype).cuda()
            a = torch.randn(shape, generator=gen).to(dtype).cuda()
            for engine in ("vector", "matrix"):
                for add in (None, a):
                    check(f"elementwise/{engine}/{dtype}/{shape}/add="
                          f"{add is not None}",
                          elementwise_call("tail", m, 1.5, add,
                                           engine=engine),
                          elementwise_plain(m, 1.5, add, engine))
                    n_checks += 1
    spmv_op = registry.get("spmv")
    for m_rows, n_cols, density in ((32, 256, 0.05), (128, 384, 0.3),
                                    (8, 128, 1.0)):
        rng = np.random.default_rng(1)
        dense = rng.standard_normal((m_rows, n_cols)).astype(np.float32)
        dense = dense * (rng.random((m_rows, n_cols)) < density)
        bell = dense_to_bell(torch.from_numpy(dense).cuda())
        x = torch.from_numpy(rng.standard_normal(n_cols).astype(
            np.float32)).cuda()
        for engine in ("vector", "matrix"):
            check(f"spmv/{engine}/{m_rows}x{n_cols}@{density}",
                  spmv_op(bell, x, engine=engine),
                  plain_of("spmv", (bell, x), {}, engine))
            n_checks += 1
    stencil_op = registry.get("stencil")
    for name, spec in sorted(suite().items()):
        shape = (1000, 1000) if spec.ndim == 2 else (96, 96, 96)
        u = torch.randn(shape, generator=gen).cuda()
        steps = TABLE3_DEPTH[name]
        # the default block, a 32-row block, and one below the halo that
        # the t*r clamp lifts
        for block_rows in (None, 32, 1):
            for engine in ("vector", "matrix"):
                check(f"stencil/{name}/{engine}/block_rows={block_rows}",
                      stencil_op(u, spec, steps=steps, engine=engine,
                                 block_rows=block_rows),
                      stencil_plain(u, spec, steps=steps, engine=engine))
                n_checks += 1
    print(f"kernel checks: {n_checks} against the plain versions, "
          f"{len(failures)} failed", flush=True)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- 4. the experiment at STREAM size ----------------------------------
    points = []
    rng = np.random.default_rng(SEED)
    for name in ("scale", "triad", "axpy"):
        op = registry.get(name)
        for dtype, n in (("float32", 2**26), ("bfloat16", 2**27)):
            args, kw = op.make_inputs(rng, n, dtype)
            points.append((op, f"{name}/{dtype}", dtype, (n,), args, kw))
    args, kw = spmv_op.make_inputs(rng, 8192, "float32")
    points.append((spmv_op, "spmv/8192x16384", "float32",
                   tuple(args[0].shape), args, kw))
    args, kw = stencil_op.make_inputs(rng, 8192, "float32")
    points.append((stencil_op, "stencil/2d5pt/8192^2", "float32",
                   (8192, 8192), args, kw))
    u3 = cast(rng.standard_normal((512, 512, 512)), "float32")
    points.append((stencil_op, "stencil/3d7pt/512^3", "float32",
                   (512, 512, 512), (u3, suite()["3d7pt"]),
                   {"steps": TABLE3_DEPTH["3d7pt"]}))
    torch.cuda.synchronize()

    _ext.reset_launches()
    results = []
    for op, point, dtype, shape, args, kw in points:
        advice = op.advice(*args, **kw)
        traits = op.traits(*args, **kw)
        outs, times = {}, {}
        outs["auto"] = op(*args, engine="auto", **kw)
        for engine in ("vector", "matrix"):
            outs[engine] = op(*args, engine=engine, **kw)
            times[engine] = time_fn(op, *args, engine=engine, warmup=WARMUP,
                                    iters=ITERS, **kw)
        results.append((op, point, dtype, shape, args, kw, advice, traits,
                        outs, times))
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    for op in registry.all_ops():
        for engine in ("vector", "matrix"):
            if launches.get(f"{op.name}_{engine}", 0) == 0:
                failures.append(f"{op.name}_{engine}: no launch on the main "
                                f"path")

    rows = []
    for (op, point, dtype, shape, args, kw, advice, traits, outs,
         times) in results:
        ratio = times["matrix"].median_us / times["vector"].median_us
        bytes_s = traits.traffic_bytes / hw.mem_bw
        ops_s = traits.work_flops / PEAK_OPS
        bound_ms = max(bytes_s, ops_s) * 1e3
        bound_by = "bytes" if bytes_s >= ops_s else "operations"
        if op.name == "spmv":
            # float32 sums of ~16k products per row: hold the error to
            # 1e-5 of the row's sum of |a_ij x_j|
            bell, x = args
            xg = x.reshape(-1, bell.bn)[bell.cols.long()].abs()
            scale = (bell.blocks.abs() * xg[:, :, None, :]).sum(
                dim=(1, 3)).max().item()
            tol = 1e-5 * max(1.0, scale)
        else:
            tol = F32_TOL
        plain_t = {}
        for engine in ("vector", "matrix"):
            want = plain_of(op.name, args, kw, engine)
            err = check(f"{point}/{engine} at full size", outs[engine], want,
                        tol)
            plain_t[engine] = time_fn(plain_of, op.name, args, kw, engine,
                                      warmup=1, iters=5)
            t = times[engine]
            line = {
                "point": point, "kernel": op.name, "engine": engine,
                "dtype": dtype, "shape": list(shape),
                "median_us": t.median_us, "iqr_us": t.iqr_us,
                "iters": t.iters,
                "GB/s": traits.traffic_bytes / t.median_us / 1e3,
                "bw_share": traits.traffic_bytes / (t.median_us * 1e-6)
                / hw.mem_bw,
                "engine_auto": advice.engine,
                "max_speedup_matrix": advice.max_speedup_matrix,
                "matrix_over_vector_time": ratio,
                "eq23_ceiling": ceiling,
                "card": card,
            }
            print(json.dumps(line), flush=True)
            rows.append({"name": f"{op.name}_{engine}", "point": point,
                         "dtype": dtype, "err": err, "t": t,
                         "plain": plain_t[engine], "bound_ms": bound_ms,
                         "bound_by": bound_by, "op": op.name})
        check(f"{point}/auto at full size", outs["auto"],
              outs[advice.engine], 0.0)

    # -- 5. library yardsticks and the per-kernel line ----------------------
    library = {}
    for (op, point, dtype, shape, args, kw, *_rest) in results:
        library[point] = _library_ms(torch, F, op.name, args, kw, time_fn)
    kernels = []
    for r in rows:
        kernels.append({
            "name": r["name"], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCE[r['op']]}.cu",
            "replaces": REPLACES[r["op"]],
            "launches": launches.get(r["name"], 0),
            "max_abs_err": r["err"],
            "ms": r["t"].median_us / 1e3,
            "plain_ms": r["plain"].median_us / 1e3,
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": library[r["point"]],
            "point": r["point"], "dtype": r["dtype"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _library_ms(torch, F, name, args, kw, time_fn):
    """One PyTorch call computing the same function, timed; None if there is
    none for this input (the reason is printed)."""
    if name == "scale":
        b, q = args
        fn = (torch.mul, b, q)
    elif name == "triad":
        b, c, q = args
        fn = (lambda: torch.add(b, c, alpha=q),)
    elif name == "axpy":
        a, x, y = args
        fn = (lambda: torch.add(y, x, alpha=a),)
    elif name == "spmv":
        bell, x = args
        nbr, mb, bm, bn = bell.blocks.shape
        cols = bell.cols.long()
        if bool((cols[:, 1:] <= cols[:, :-1]).any()):
            print("library spmv: zero-padded slots repeat a column id, which "
                  "a BSR tensor cannot hold", flush=True)
            return None
        crow = torch.arange(0, nbr * mb + 1, mb, device=x.device)
        try:
            bsr = torch.sparse_bsr_tensor(crow, cols.reshape(-1),
                                          bell.blocks.reshape(-1, bm, bn),
                                          size=bell.shape)
            bsr @ x[:, None]
        except (RuntimeError, NotImplementedError, ValueError) as exc:
            print(f"library spmv: torch's BSR matvec refuses "
                  f"{bm}x{bn} blocks: {str(exc).splitlines()[0]}", flush=True)
            return None
        fn = (lambda: bsr @ x[:, None],)
    else:
        u, spec = args
        steps = kw["steps"]
        r = spec.radius
        w = torch.zeros((2 * r + 1,) * spec.ndim, device=u.device)
        for off, wt in zip(spec.offsets, spec.weights):
            w[tuple(o + r for o in off)] += wt
        conv = F.conv2d if spec.ndim == 2 else F.conv3d
        x0 = u[None, None]
        wk = w[None, None]

        def run():
            v = x0
            for _ in range(steps):
                v = conv(v, wk, padding=r)
            return v
        fn = (run,)
    return time_fn(*fn, warmup=WARMUP, iters=ITERS).median_us / 1e3


if __name__ == "__main__":
    sys.exit(main())
