#!/usr/bin/env python3
"""Time one (ndim, kind, engine) object of the stencil kernels, or of a
variant copy of ``csrc/stencil.cu``, at its experiment point.

    python3 tools/stencil_variant.py NAME=PART[:SOURCE] ...

PART is the object number of ``csrc/stencil.cu`` (4 ndim == 3 + 2 box +
matrix: 0 = 2-D star vector ... 7 = 3-D box matrix); SOURCE a copy of
``stencil.cu`` with a design change (default: the checkout's own).  All
variants are built at once by ``nvcc`` (with ``-Xptxas -v``), each behind a
small C entry point that calls its object's launcher directly.  Each is then
run once on the point of its (ndim, kind) -- 2d5pt / 2d9pt on 8192^2, 3d7pt /
3d27pt on 512^3, t = 3, block_rows 128 -- and held bit for bit against
``stencil_plain``, then timed (CUDA-event median of 20 calls after 3
warm-ups).  Prints one JSON line per variant with, per kernel (radius),
ptxas's registers and spills and the SASS instructions and DMMAs, and the
card's name and power limit.  Needs an NVIDIA card.
"""
from __future__ import annotations

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
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
ENTRY = """#include "{source}"
extern "C" int variant_launch(const float* u, float* out, int n0, int n1,
                              int n2, int steps, int block_rows,
                              const float* w, int npts, const float* axw,
                              float center, int radius, void* stream) {{
  using namespace repro_stencil;
  Params p;
  p.u = u; p.out = out; p.n0 = n0; p.n1 = n1; p.n2 = n2; p.steps = steps;
  p.block_rows = block_rows; p.center = center;
  for (int a = 0; a < 3; ++a)
    for (int d = 0; d < kMaxTaps; ++d) p.axw[a][d] = axw[a * kMaxTaps + d];
  for (int j = 0; j < kMaxPoints; ++j) p.w[j] = j < npts ? w[j] : 0.f;
  return launch_part<REPRO_PART>(radius, p, static_cast<cudaStream_t>(stream));
}}
"""
POINTS = {(2, False): ("2d5pt", (8192, 8192)), (2, True): ("2d9pt", (8192, 8192)),
          (3, False): ("3d7pt", (512,) * 3), (3, True): ("3d27pt", (512,) * 3)}


def _kernels(ptxas: str, lib: pathlib.Path):
    """Per kernel of the object (its radius): ptxas's registers and spills,
    and the SASS instructions and DMMAs cuobjdump counts."""
    from repro_torch.kernels._ext import _nvcc
    out, name = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            name = "r" + re.search(r"ILi\dELi(\d)", line).group(1)
            out[name] = {}
        elif name and ("spill" in line or "Used" in line):
            out[name].setdefault("ptxas", []).append(
                line.split(":", 1)[-1].strip())
    sass = subprocess.run([os.path.join(os.path.dirname(_nvcc()), "cuobjdump"),
                           "--dump-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = "r" + re.search(r"ILi\dELi(\d)", line).group(1)
            out.setdefault(name, {}).update(sass=0, dmma=0)
        elif re.match(r"/\*[0-9a-f]+\*/", line) and name in out:
            out[name]["sass"] += 1
            out[name]["dmma"] += " DMMA" in line
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._ext import NVCC_FLAGS, _nvcc
    from repro_torch.kernels.stencil.defs import TABLE3_DEPTH, suite
    from repro_torch.kernels.stencil.stencil import stencil_plain

    work = pathlib.Path(tempfile.mkdtemp(prefix="stencil_variant_"))
    variants = {}
    for arg in sys.argv[1:]:
        name, spec = arg.split("=", 1)
        part, _, source = spec.partition(":")
        src = pathlib.Path(source).resolve() if source else CSRC / "stencil.cu"
        entry = work / f"{name}.cu"
        entry.write_text(ENTRY.format(source=src))
        lib = work / f"{name}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", f"-DREPRO_PART={int(part)}",
               "-I", str(CSRC), "-Xptxas", "-v", "-o", str(lib), str(entry)]
        variants[name] = (int(part), lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    ptxas = {name: proc.communicate()[0]
             for name, (_, _, proc) in variants.items()}
    build_s = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (part, lib, proc) in variants.items():
        if proc.returncode:
            print(json.dumps({"variant": name, "build_failed":
                              ptxas[name][-2000:]}), flush=True)
            continue
        fn = ctypes.CDLL(str(lib), mode=os.RTLD_LAZY).variant_launch
        fn.argtypes = [P, P, I, I, I, I, I, P, I, P, F, I, P]
        fn.restype = I
        nd, box, matrix = 3 if part >= 4 else 2, part // 2 % 2 == 1, part % 2
        sname, shape = POINTS[(nd, box)]
        spec, steps = suite()[sname], TABLE3_DEPTH[sname]
        if sname not in inputs:
            inputs[sname] = torch.randn(shape, generator=gen, device="cuda")
        u = inputs[sname]
        n0, n1, n2 = shape if nd == 3 else (shape[0], 1, shape[1])
        axw = [0.0] * 21  # rows: blocked axis, y, x
        for ax, w1d in enumerate(spec.axis_weights):
            row = ax if nd == 3 else 2 * ax
            axw[row * 7:row * 7 + len(w1d)] = w1d
        c_w = (F * spec.num_points)(*spec.weights)
        c_axw = (F * 21)(*axw)
        out = torch.empty_like(u)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            code = fn(u.data_ptr(), out.data_ptr(), n0, n1, n2, steps, 128,
                      c_w, spec.num_points, c_axw, float(spec.center),
                      spec.radius, stream)
            if code:
                raise RuntimeError(f"{name}: launch failed ({code})")
        call()
        want = stencil_plain(u, spec, steps=steps,
                             engine="matrix" if matrix else "vector")
        equal = bool(torch.equal(out, want))
        del want
        for _ in range(3):
            call()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(20)]
        for start, end in events:
            start.record()
            call()
            end.record()
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) * 1e3 for s, e in events)
        print(json.dumps({"variant": name, "part": part, "point": sname,
                          "engine": "matrix" if matrix else "vector",
                          "median_us": times[10], "min_us": times[0],
                          "equal": equal, "kernels": _kernels(ptxas[name], lib),
                          "build_s": build_s, "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
