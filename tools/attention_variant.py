#!/usr/bin/env python3
"""Check and time variant copies of the flash-decode kernels at one point.

    python3 tools/attention_variant.py [--g 16 --kh 4 --dh 128]
        [--dtype bfloat16] [--engine vector] NAME[=SOURCE] ...

SOURCE is a copy of ``csrc/attention.cu`` with a design change (default:
the checkout's own).  All variants are built at once by ``nvcc``, each as
its own library of the one head dim (``-DREPRO_ATTENTION_ONLY_DH``, with
``-Xptxas -v``), and loaded beside the checkout's ``_ext``.  Each is run at
the decode point (B 4, S 32768, kv_len 28672; default Qwen3-MoE-235B's
KH 4, G 16, Dh 128) with the ranges ``_ext.attention_ranges`` gives, held
against ``flash_decode_plain`` (bfloat16: one ulp, floor 1/256 of the
largest output) and bit for bit against reading every position (end = S)
at kv_len 28672 and at 1, 15, 17 and 64 on a 1024-position cache, then
timed: CUDA-event median and IQR of 20 calls after 3 warm-ups, and
torch.profiler's device time per call (the union of its kernels'
intervals over 20 calls).  Prints one JSON line per variant with the
range kernel's ptxas registers and spills, its SASS instruction count and
most frequent opcodes (``--sass-dir D`` writes its SASS listing to
``D/NAME.sass``), and the card's name and power limit.  Needs an NVIDIA
card.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sass_mix(lib: pathlib.Path, symbol: str, nvcc: str, dump=None):
    """(instructions, top opcodes) of the kernel whose mangled name
    contains ``symbol``, from cuobjdump's SASS; its listing is written to
    ``dump`` if given."""
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "--dump-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    ops, inside, listing = collections.Counter(), False, []
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            inside = symbol in line
        elif inside:
            listing.append(line)
            m = re.match(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                         line)
            if m:
                ops[m.group(1).split(".")[0]] += 1
    if dump is not None:
        pathlib.Path(dump).write_text("\n".join(listing) + "\n")
    return sum(ops.values()), ops.most_common(16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME[=SOURCE]")
    ap.add_argument("--g", type=int, default=16)
    ap.add_argument("--kh", type=int, default=4)
    ap.add_argument("--dh", type=int, default=128)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="bfloat16")
    ap.add_argument("--engine", choices=("vector", "matrix"),
                    default="vector")
    ap.add_argument("--sass-dir", default=None,
                    help="write each variant's range-kernel SASS here")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_variant: no card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core.timing import device_busy_us, time_fn
    from repro_torch.kernels import _ext
    from repro_torch.kernels.attention.flash_decode import flash_decode_plain

    work = pathlib.Path(tempfile.mkdtemp(prefix="attention_variant_"))
    builds = {}
    for arg in opts.variants:
        name, _, source = arg.partition("=")
        src = pathlib.Path(source).resolve() if source else \
            _ext.CSRC / "attention.cu"
        lib = work / f"{name}.so"
        cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS, "-shared", "-I", str(_ext.CSRC),
               f"-DREPRO_ATTENTION_ONLY_DH={opts.dh}", "-o", str(lib), str(src)]
        builds[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    logs = {name: proc.communicate()[0] for name, (_, proc) in
            builds.items()}
    build_s = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dtype = getattr(torch, opts.dtype)
    matrix = opts.engine == "matrix"
    b, s = 4, 32768
    kv_len = s - s // 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, opts.kh, opts.g, opts.dh),
                             (b, s, opts.kh, opts.dh),
                             (b, s, opts.kh, opts.dh)))
    small = [t[:1, :, :, :].contiguous() if t is q else
             t[:1, :1024].contiguous() for t in (q, k, v)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scale = float(np.float32(1.0) / np.sqrt(np.float32(opts.dh)))
    ht = 8 if opts.g <= 8 else 16
    symbol = (f"attention_{opts.engine}_kernelI"
              f"{'f' if opts.dtype == 'float32' else '13__nv_bfloat16'}"
              f"Li{opts.dh}ELi{ht}E")

    def floor_ulp_ok(got, want):
        if got.dtype != torch.bfloat16:
            return bool((got - want).abs().max() <= 1e-4)
        mag = want.float().abs()
        mag = mag.clamp_min(max(mag.max().item() / 256, 1e-30))
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        return bool(((got.float() - want.float()).abs() <= ulp).all())

    for name, (lib, proc) in builds.items():
        if proc.returncode:
            print(json.dumps({"variant": name,
                              "build_failed": logs[name][-3000:]}),
                  flush=True)
            continue
        fn = ctypes.CDLL(str(lib), mode=os.RTLD_LAZY).attention_launch
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, I, I,
                       P]
        fn.restype = I

        def launch(qq, kk, vv, kl, rows, nsplit, end):
            bb, kh, g, dh = qq.shape
            out = torch.empty_like(qq)
            pairs = bb * kh
            ml = torch.empty(max(pairs * nsplit * g * 2, 1), device="cuda")
            acc = torch.empty(max(pairs * nsplit * g * dh, 1), device="cuda")
            code = fn(qq.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                      out.data_ptr(), ml.data_ptr(), acc.data_ptr(), bb, kh,
                      g, kk.shape[1], dh, kl, end, rows, nsplit, scale,
                      int(dtype == torch.bfloat16), int(matrix),
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"{name}: launch failed ({code})")
            return out

        checks = []
        for qq, kk, vv, kl, block in ((q, k, v, kv_len, 512),
                                      *((*small, kl, 128)
                                        for kl in (1, 15, 17, 64))):
            ss = kk.shape[1]
            rows, nsplit, end = _ext.attention_ranges(
                ss, block, qq.shape[0] * qq.shape[1], sms, kl, dtype,
                opts.g, opts.engine, opts.dh)
            got = launch(qq, kk, vv, kl, rows, nsplit, end)
            want = flash_decode_plain(qq, kk, vv, kl, block_s=block,
                                      engine=opts.engine)
            full = launch(qq, kk, vv, kl, rows, -(-ss // rows), ss)
            torch.cuda.synchronize()
            checks.append({"kv_len": kl, "s": ss,
                           "max_abs_err": (got.float() - want.float())
                           .abs().max().item(),
                           "within_tolerance": floor_ulp_ok(got, want),
                           "equal_to_full_read": bool(torch.equal(got,
                                                                  full))})
        rows, nsplit, end = _ext.attention_ranges(
            s, 512, b * opts.kh, sms, kv_len, dtype, opts.g, opts.engine,
            opts.dh)

        def call():
            return launch(q, k, v, kv_len, rows, nsplit, end)
        t = time_fn(call, warmup=3, iters=20)
        device_us = device_busy_us(call, calls=20)
        usage = {fn_: u for fn_, u in _ext.parse_ptxas(logs[name]).items()
                 if symbol in fn_}
        dump = None
        if opts.sass_dir:
            os.makedirs(opts.sass_dir, exist_ok=True)
            dump = os.path.join(opts.sass_dir, f"{name}.sass")
        count, top = _sass_mix(lib, symbol, _ext._nvcc(), dump)
        print(json.dumps({
            "variant": name, "g": opts.g, "kh": opts.kh, "dh": opts.dh,
            "dtype": opts.dtype, "engine": opts.engine, "rows": rows,
            "nsplit": nsplit, "median_us": t.median_us, "iqr_us": t.iqr_us,
            "profiler_device_us": device_us, "checks": checks,
            "ptxas": next(iter(usage.values()), None),
            "sass_instructions": count, "sass_top": top,
            "build_s": build_s, "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
