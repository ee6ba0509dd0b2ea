#!/usr/bin/env python3
"""Time the elementwise kernels, block-ELL SpMV, the stencils and
flash-decode at chip_smoke.py's experiment points.

    python3 tools/kernel_points.py [--root DIR] [--label NAME]
        [--points {elementwise,spmv,stencil,attention,decode} ...]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
that checkout's kernels, and prints one JSON line per point and engine: the
CUDA-event median and IQR of 20 calls after 3 warm-ups, the host's enqueue
time per call, the device time per call (torch.profiler: the union of the
intervals in which the call's kernels run, and each kernel's own mean
duration), and the card's name and power limit.  The points (``--points``
picks some, default all): SCALE, STREAM Triad and AXPY at float32
n = 2^26 and bfloat16 n = 2^27; SpMV on the 8192 x 16384 matrix at 5%
density; the stencils 2d5pt on 8192^2 and 3d7pt on 512^3 at t = 3;
flash-decode at Mistral-NeMo-12B's decode shape (B 4, KH 8, G 4, Dh 128),
at Qwen3-MoE-235B-A22B's (B 4, KH 4, G 16) and at StableLM-2-12B's (B 4,
KH 8, G 4, Dh 160) over S = 32768 with kv_len = 7S/8, in float32 and
bfloat16 (a checkout whose kernels refuse a point's G or Dh prints one
``refused`` line for it); ``decode``: float32 flash-decode at the
decode shapes of the configs and cells that run it at a head tile of 8
(DECODE_POINTS), beside the byte bound of its valid positions at the
datasheet 3.35 TB/s.  Yardsticks are
timed beside them: ``torch.mul`` / ``torch.add(..., alpha=q)`` on the same
arrays, ``torch.mv`` on the same matrix in CSR, ``F.conv2d`` /
``F.conv3d`` with the stencil's weights, t times, and
``scaled_dot_product_attention`` on the kv_len valid positions.  Every
call is timed through a closure, so the tool runs against older checkouts
whose ``time_fn`` forwards keywords.

Two checkouts are compared on one card by running this once per checkout in
turns within one command, e.g. ``A B B A``.  Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

WARMUP, ITERS = 3, 20
POINTS = ("elementwise", "spmv", "stencil", "attention", "decode")
#: (name, B, KH, G, Dh, S, kv_len) of float32 flash-decode in the main
#: path at a head tile of 8: the decode cells' layer call at a mid-window
#: kv_len, the stream cells' K4 point, StableLM-2-12B's head dim, and the
#: short caches of Zamba2-7B, SeamlessM4T-large-v2 and Qwen2-VL-72B
DECODE_POINTS = (("mistral-decode-cell", 16, 8, 4, 128, 32768, 28900),
                 ("stream-k4", 4, 8, 4, 128, 32768, 28672),
                 ("stablelm-dh160", 4, 8, 4, 160, 32768, 28672),
                 ("zamba2", 4, 32, 1, 112, 512, 512),
                 ("seamless-m4t", 4, 16, 1, 64, 512, 512),
                 ("qwen2-vl", 4, 8, 8, 128, 1536, 1536))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1]),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--label", default=None, help="name printed per line")
    ap.add_argument("--points", nargs="+", choices=POINTS, default=POINTS,
                    help="which kernels' points to time (default: all)")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_points: no card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(opts.root) / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core.timing import time_fn
    from repro_torch.kernels import _ext, registry

    label = opts.label or opts.root
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _ext.build(tuple(n for n in _ext.SOURCES if n in opts.points or
                     (n == "attention" and "decode" in opts.points)))
    build_s = time.perf_counter() - t0

    def device_us(fn, calls=20):
        """torch.profiler's device time per call: the union of the
        intervals in which the calls' kernels run, over back-to-back calls
        (a dependent kernel launched early counts once), and each kernel's
        own mean duration (a dependent's includes its wait)."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        # repro_torch.core.timing.busy_us, repeated here: the checkout
        # under --root may predate it
        busy, end = 0.0, float("-inf")
        for start, stop in sorted((e.time_range.start, e.time_range.end)
                                  for e in events):
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        per_kernel = {}
        for e in events:
            bare = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
            name = re.split(r"[<(]", bare)[0]
            per_kernel[name] = per_kernel.get(name, 0.0) + \
                (e.time_range.end - e.time_range.start) / calls
        return busy / calls, per_kernel

    def host_us(fn, calls=50):
        """The host's enqueue time per call, with no synchronisation."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        return elapsed / calls * 1e6

    def emit(point, engine, fn, **extra):
        t = time_fn(fn, warmup=WARMUP, iters=ITERS)
        busy, per_kernel = device_us(fn)
        print(json.dumps({"label": label, "point": point, "engine": engine,
                          "median_us": t.median_us, "iqr_us": t.iqr_us,
                          "host_enqueue_us": host_us(fn),
                          "profiler_device_us": busy,
                          "profiler_kernel_us": per_kernel, **extra,
                          "card": card, "build_s": build_s}), flush=True)

    if "elementwise" in opts.points:
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype, n in ((torch.float32, 2**26), (torch.bfloat16, 2**27)):
            m, a = (torch.randn(n, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            q = 1.5
            # (op arguments, the library call computing the same function)
            calls = {
                "scale": ((m, q), lambda: torch.mul(m, q)),
                "triad": ((a, m, q), lambda: torch.add(a, m, alpha=q)),
                "axpy": ((q, m, a), lambda: torch.add(a, m, alpha=q)),
            }
            for name, (args, library) in calls.items():
                op = registry.get(name)
                point = f"{name}/{str(dtype)[6:]}/n{n}"
                for engine in ("vector", "matrix"):
                    emit(point, engine,
                         lambda: op(*args, engine=engine))
                lib = "torch.mul" if name == "scale" else \
                    "torch.add(alpha=q)"
                emit(point, f"library: {lib}", library)
            del m, a, calls
            torch.cuda.empty_cache()

    if "spmv" in opts.points:
        spmv = registry.get("spmv")
        (bell, x), kw = spmv.make_inputs(np.random.default_rng(0), 8192,
                                         "float32")
        for engine in ("vector", "matrix"):
            emit("spmv/8192x16384", engine,
                 lambda: spmv(bell, x, engine=engine, **kw))
        csr = bell.todense().to_sparse_csr()
        emit("spmv/8192x16384", "library: torch.mv on CSR",
             lambda: torch.mv(csr, x))
        del bell, x, csr

    if "stencil" in opts.points:
        from repro_torch.kernels.stencil.defs import TABLE3_DEPTH, suite
        stencil = registry.get("stencil")
        torch.backends.cudnn.allow_tf32 = False
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name, shape in (("2d5pt", (8192, 8192)), ("3d7pt", (512,) * 3)):
            spec, steps = suite()[name], TABLE3_DEPTH[name]
            u = torch.randn(shape, generator=gen, device="cuda")
            point = f"stencil/{name}/{'x'.join(map(str, shape))}"
            for engine in ("vector", "matrix"):
                emit(point, engine,
                     lambda: stencil(u, spec, steps=steps, engine=engine))
            # the same function as one PyTorch call per step: a convolution
            # with the stencil's weights and zero padding r
            r = spec.radius
            w = torch.zeros((2 * r + 1,) * spec.ndim, device="cuda")
            for off, wt in zip(spec.offsets, spec.weights):
                w[tuple(o + r for o in off)] += wt
            conv = F.conv2d if spec.ndim == 2 else F.conv3d
            x0, wk = u[None, None], w[None, None]

            def library():
                v = x0
                for _ in range(steps):
                    v = conv(v, wk, padding=r)
                return v
            emit(point, f"library: F.conv{spec.ndim}d x {steps}", library)
            del u, x0
            torch.cuda.empty_cache()

    if "attention" in opts.points:
        attention = registry.get("attention")
        s = 32768
        kv_len = s - s // 8
        gen = torch.Generator().manual_seed(0)
        cgen = torch.Generator(device="cuda").manual_seed(0)
        for (b, kh, g, dh), dtype in ((shape, dtype) for shape in
                                      ((4, 8, 4, 128), (4, 4, 16, 128),
                                       (4, 8, 4, 160))
                                      for dtype in (torch.float32,
                                                    torch.bfloat16)):
            q = torch.randn((b, kh, g, dh), generator=gen).to(dtype).cuda()
            k, v = (torch.randn((b, s, kh, dh), generator=cgen,
                                device="cuda").to(dtype) for _ in range(2))
            point = f"attention/{str(dtype)[6:]}/B{b}xS{s}" + \
                ("" if g == 4 else f"xG{g}") + \
                ("" if dh == 128 else f"xDh{dh}")
            try:
                attention(q, k, v, kv_len, engine="vector")
            except ValueError as exc:
                print(json.dumps({"label": label, "point": point,
                                  "refused": str(exc), "card": card}),
                      flush=True)
                del q, k, v
                continue
            for engine in ("vector", "matrix"):
                emit(point, engine,
                     lambda: attention(q, k, v, kv_len, engine=engine))
            qs = q.reshape(b, kh * g, 1, dh)
            ks = k[:, :kv_len].permute(0, 2, 1, 3).contiguous()
            vs = v[:, :kv_len].permute(0, 2, 1, 3).contiguous()
            emit(point, "library: scaled_dot_product_attention",
                 lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                        enable_gqa=True))
            del q, k, v, qs, ks, vs
            torch.cuda.empty_cache()

    if "decode" in opts.points:
        attention = registry.get("attention")
        cgen = torch.Generator(device="cuda").manual_seed(0)
        for name, b, kh, g, dh, s, kv_len in DECODE_POINTS:
            q, k, v = (torch.randn(shape, generator=cgen, device="cuda")
                       for shape in ((b, kh, g, dh), (b, s, kh, dh),
                                     (b, s, kh, dh)))
            bound_us = 2 * b * kv_len * kh * dh * 4 / 3.35e12 * 1e6
            for engine in ("vector", "matrix"):
                emit(f"decode/{name}/B{b}xKH{kh}xG{g}xDh{dh}xS{s}", engine,
                     lambda: attention(q, k, v, kv_len, engine=engine),
                     kv_len=kv_len, bound_us=bound_us)
            del q, k, v
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
