"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, all files at once, at first
use; the libraries are cached under ``build/repro_torch_ext/`` by a hash
of their source and flags, and loaded with ``ctypes``.  A plain C
interface keeps PyTorch's headers out of the build, which then takes
seconds instead of minutes.  A file of many kernel instantiations
(``PARTS``) is compiled as several objects at once, ``-DREPRO_PART=k``
selecting object k's kernels, and linked into its library.

Every launch wrapper here checks device, dtype, shape, contiguity and
alignment, launches on PyTorch's current stream, raises if the launch
was refused, and adds one to its kernel's count in ``LAUNCHES``.  Build
and launch errors propagate; nothing falls back to the plain versions.
``ptxas -v`` reports each kernel's registers, spills and shared memory
while it compiles; the build keeps that report beside each library
(``ptxas_usage`` reads it).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["CTAS_PER_SM", "ELEMENTWISE_THREADS", "HEAD_DIMS", "LAUNCHES",
           "MAX_GROUP", "attention", "attention_kernel_usage",
           "attention_launch", "attention_ranges", "attention_ring",
           "attention_split",
           "build", "ctas_per_sm", "elementwise", "elementwise_grid",
           "experts",
           "mma_instructions", "parse_ptxas", "ptxas_usage",
           "reset_launches", "spmv", "stencil", "stencil_offsets"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_ext"
SOURCES = ("attention", "elementwise", "experts", "spmv", "stencil")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Sources compiled as this many objects in parallel: ``stencil.cu``
#: specialises 24 kernels, 3 per object; ``attention.cu`` one head dim
#: (both dtypes, head tiles and engines) per object.
PARTS = {"stencil": 8, "attention": 6}

#: Launches per kernel ("scale_vector", "spmv_matrix", ...) since the
#: last ``reset_launches()``.
LAUNCHES: Dict[str, int] = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    """Set every launch count to 0."""
    LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(str(PARTS.get(name, 0)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _commands(name: str, out: pathlib.Path):
    """(compile commands, link command or None) building ``out``."""
    src = str(CSRC / f"{name}.cu")
    n = PARTS.get(name, 0)
    if not n:
        return [[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out), src]], None
    objs = [str(out.with_suffix(f".{k}.o")) for k in range(n)]
    return ([[_nvcc(), *NVCC_FLAGS, "-c", f"-DREPRO_PART={k}", "-o", o, src]
             for k, o in enumerate(objs)],
            [_nvcc(), "-shared", "-o", str(out), *objs])


def _ptxas_log(name: str) -> pathlib.Path:
    return _lib_path(name).with_suffix(".ptxas.txt")


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """``{kernel symbol: {"registers", "spill_store_bytes",
    "spill_load_bytes", "stack_bytes", "smem_bytes": n}}`` from the
    output of ``nvcc -Xptxas -v`` (keys a kernel's report lacks are
    absent)."""
    import re
    pats = (("stack_bytes", r"(\d+) bytes stack frame"),
            ("spill_store_bytes", r"(\d+) bytes spill stores"),
            ("spill_load_bytes", r"(\d+) bytes spill loads"),
            ("registers", r"Used (\d+) registers"),
            ("smem_bytes", r"(\d+) bytes smem"))
    fn, usage = None, {}
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, {})
            continue
        if fn is None:
            continue
        for key, pat in pats:
            m = re.search(pat, line)
            if m:
                usage[fn][key] = int(m.group(1))
    return usage


def ptxas_usage(name: str = "attention") -> Dict[str, Dict[str, int]]:
    """The ptxas report of source ``name``'s kernels (``parse_ptxas``),
    kept by the build that made its library."""
    build((name,))
    return parse_ptxas(_ptxas_log(name).read_text())


def attention_kernel_usage() -> List[Dict[str, object]]:
    """One dict per flash-decode range kernel (``attention_{vector,
    matrix}_kernel<T, DH, HT>``, and the float32 ring kernels at a head
    tile of 8, ``attention_{vector,matrix}_ring_kernel<DH>``): engine,
    dtype, head dim, head tile and its ``ptxas_usage`` counts, in (dtype,
    head dim, head tile, engine) order."""
    import re
    rows = []
    for fn, u in ptxas_usage("attention").items():
        m = re.search(r"attention_(vector|matrix)_kernelI(f|13__nv_bfloat16)"
                      r"Li(\d+)ELi(\d+)E", fn)
        if m:
            rows.append({"engine": m.group(1),
                         "dtype": "float32" if m.group(2) == "f"
                         else "bfloat16",
                         "dh": int(m.group(3)), "head_tile": int(m.group(4)),
                         **u})
        m = re.search(r"attention_(vector|matrix)_ring_kernelILi(\d+)E", fn)
        if m:
            rows.append({"engine": m.group(1), "dtype": "float32",
                         "dh": int(m.group(2)), "head_tile": 8, **u})
    return sorted(rows, key=lambda r: (r["dtype"], r["dh"], r["head_tile"],
                                       r["engine"]))


def mma_instructions() -> Dict[str, Dict[str, int]]:
    """Tensor-core instructions per compiled kernel, from the built SASS.

    ``{kernel symbol: {"DMMA": n, "HMMA": n}}`` over every library, read
    with ``cuobjdump --dump-sass``: the audit that each matrix kernel
    really issues MMA and each vector kernel none.
    """
    build()
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    counts: Dict[str, Dict[str, int]] = {}
    for n in SOURCES:
        sass = subprocess.run([tool, "--dump-sass", str(_lib_path(n))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        fn = None
        for line in sass.splitlines():
            line = line.strip()
            if line.startswith("Function :"):
                fn = line.split(":", 1)[1].strip()
                counts[fn] = {"DMMA": 0, "HMMA": 0}
            elif fn is not None:
                for op in ("DMMA", "HMMA"):
                    if f" {op}." in line or f" {op} " in line:
                        counts[fn][op] += 1
    return counts


def build(names: Sequence[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Compile (if not cached) and load the named kernel libraries.

    One ``nvcc`` per source (per object of a source in ``PARTS``), all
    started together.  Raises with the compiler's output if any of them
    fails.
    """
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        if not todo:
            return _LIBS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for n in todo:
            path = _lib_path(n)
            if path.exists():
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            compiles, link = _commands(n, tmp)
            jobs[n] = ([subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
                        for cmd in compiles], link, tmp, path)
        failed = []
        for n, (procs, link, tmp, path) in jobs.items():
            outs = [(proc.communicate()[0], proc.returncode)
                    for proc in procs]
            if link is not None and not any(rc for _, rc in outs):
                done = subprocess.run(link, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                outs.append((done.stdout, done.returncode))
            bad = [(out, rc) for out, rc in outs if rc != 0]
            if bad:
                failed += [f"--- {n}.cu (nvcc exit {rc}) ---\n{out}"
                           for out, rc in bad]
            else:
                _ptxas_log(n).write_text("".join(out for out, _ in outs))
                os.replace(tmp, path)
            for obj in tmp.parent.glob(tmp.name[:-len(tmp.suffix)] + ".*.o"):
                obj.unlink()
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for n in todo:
            lib = ctypes.CDLL(str(_lib_path(n)))
            _declare(n, lib)
            _LIBS[n] = lib
        return _LIBS


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _declare(name: str, lib: ctypes.CDLL) -> None:
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [_I], ctypes.c_char_p
    if name == "elementwise":
        fn = lib.elementwise_launch
        fn.argtypes = [_P, _P, _P, _LL, _I, _F, _I, _I, _LL, _P]
    elif name == "attention":
        fn = lib.attention_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _F, _I, _I, _P]
    elif name == "spmv":
        fn = lib.spmv_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    elif name == "experts":
        fn = lib.experts_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    else:
        fn = lib.stencil_launch
        fn.argtypes = [_P, _P, _P, _I, _P, _P, _I, _P, _F, _I, _I, _I, _I,
                       _I, _P]
    fn.restype = _I


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    return lib if lib is not None else build((name,))[name]


def _check(name: str, code: int, kernel: str) -> None:
    if code != 0:
        msg = getattr(_lib(name), f"{name}_error_string")(code)
        raise RuntimeError(f"{kernel} launch failed: {msg.decode()} "
                           f"(cudaError {code})")
    LAUNCHES[kernel] += 1


def _need(t: torch.Tensor, what: str, dtype: Optional[torch.dtype] = None
          ) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a tensor on the "
                         f"card, got one on {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the CUDA kernel needs a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the CUDA kernel needs 16-byte aligned "
                         f"data")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------------
# launch wrappers
# --------------------------------------------------------------------------

#: Threads per CTA of the elementwise kernel, one 16-byte chunk each.
ELEMENTWISE_THREADS = 256


def elementwise_grid(n: int, elem_bytes: int) -> int:
    """CTAs of one elementwise call over ``n`` elements of ``elem_bytes``
    bytes: one per ``ELEMENTWISE_THREADS`` 16-byte chunks.

    CTA ``j`` takes chunks ``[256 j, 256 j + 256)``, one per thread, and the
    last CTA the rest, so every chunk is covered once and no CTA is empty.
    The grid runs in many waves: at the STREAM sizes 65,536 CTAs, of which
    an H100 holds 1,056 at once, handed out in address order.  0 for
    ``n = 0``.
    """
    if n < 0 or elem_bytes not in (2, 4):
        raise ValueError(f"elementwise_grid: n={n}, elem_bytes={elem_bytes}")
    chunks = -(-n * elem_bytes // 16)
    return -(-chunks // ELEMENTWISE_THREADS)


def elementwise(family: str, m: torch.Tensor, q,
                add: Optional[torch.Tensor], *, engine: str) -> torch.Tensor:
    """Launch the elementwise kernel: ``q * m (+ add)`` on the grid of
    ``elementwise_grid``."""
    dtype = m.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"elementwise kernel takes float32/bfloat16, "
                         f"got {dtype}")
    _need(m, f"{family} input", dtype)
    if add is not None:
        _need(add, f"{family} addend", dtype)
        if add.shape != m.shape:
            raise ValueError(f"{family}: shapes disagree")
    out = torch.empty_like(m)
    grid = elementwise_grid(out.numel(), m.element_size())
    if grid == 0:
        return out
    with torch.cuda.device(out.device):
        code = _lib("elementwise").elementwise_launch(
            m.data_ptr(), (add if add is not None else m).data_ptr(),
            out.data_ptr(), out.numel(), int(add is not None), float(q),
            int(dtype == torch.bfloat16), int(engine == "matrix"), grid,
            _stream(out))
    _check("elementwise", code, f"{family}_{engine}")
    return out


def spmv(blocks: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
         engine: str) -> torch.Tensor:
    """Launch block-ELL SpMV; returns ``(n_block_rows, 8)`` float32."""
    nbr, mb, bm, bn = blocks.shape
    if (bm, bn) != (8, 128):
        raise ValueError(f"the SpMV kernel takes 8x128 blocks, got "
                         f"{bm}x{bn}")
    if tuple(cols.shape) != (nbr, mb) or x.ndim != 1 or x.numel() % bn:
        raise ValueError("block-ELL shapes disagree")
    _need(blocks, "spmv blocks", torch.float32)
    _need(cols, "spmv cols", torch.int32)
    _need(x, "spmv x", torch.float32)
    y = torch.empty((nbr, bm), dtype=torch.float32, device=x.device)
    matrix = engine == "matrix"
    # the matrix kernel's copy of x in double (its DMMA's B operand)
    xd = torch.empty(x.numel(), dtype=torch.float64, device=x.device) \
        if matrix else None
    with torch.cuda.device(y.device):
        code = _lib("spmv").spmv_launch(
            blocks.data_ptr(), cols.data_ptr(), x.data_ptr(),
            None if xd is None else xd.data_ptr(), y.data_ptr(),
            nbr, mb, x.numel() // bn, int(matrix), _stream(y))
    _check("spmv", code, f"spmv_{engine}")
    return y


def experts(xs: torch.Tensor, offsets: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Launch the grouped SwiGLU of an expert share (``csrc/experts.cu``):
    ``xs`` (P, D) rows sorted by held expert, expert e's at ``offsets[e]
    .. offsets[e + 1]`` (int32, n + 1, on the card), ``w_gate`` / ``w_up``
    (n, D, F), ``w_down`` (n, F, D).  Returns y (P, D) float32, whose rows
    past ``offsets[n]`` are left unwritten."""
    n, d, f = w_gate.shape
    if (tuple(w_up.shape) != (n, d, f) or tuple(w_down.shape) != (n, f, d)
            or xs.ndim != 2 or xs.shape[1] != d
            or tuple(offsets.shape) != (n + 1,)):
        raise ValueError("expert share shapes disagree")
    for t, what in ((xs, "experts xs"), (w_gate, "experts w_gate"),
                    (w_up, "experts w_up"), (w_down, "experts w_down")):
        _need(t, what, torch.float32)
    _need(offsets, "experts offsets", torch.int32)
    h = torch.empty((xs.shape[0], f), dtype=torch.float32, device=xs.device)
    y = torch.empty((xs.shape[0], d), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(y.device):
        code = _lib("experts").experts_launch(
            xs.data_ptr(), offsets.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), y.data_ptr(),
            n, d, f, _stream(y))
    _check("experts", code, "experts")
    return y


#: Most stencil points the vector kernel's constant table holds (a 3-D
#: box of radius 3).
MAX_STENCIL_POINTS = 343
MAX_RADIUS = 3


def stencil_offsets(ndim: int, radius: int, kind: str):
    """The offsets, in order, that the stencil kernels are compiled for: a
    star's or a separable box's as ``kernels/stencil/defs.py`` builds them
    (the order of the vector engine's multiply-adds)."""
    from .stencil.defs import _box_separable, _star
    if kind == "star":
        return _star("", ndim, radius, (0.0,) * radius, 0.0).offsets
    if kind == "box":
        return _box_separable("", ndim, radius,
                              (0.0,) * (2 * radius + 1)).offsets
    raise ValueError(f"stencil kind {kind!r}: the kernels take star or box")


def stencil(u: torch.Tensor, spec, *, steps: int, engine: str,
            block_rows: int) -> torch.Tensor:
    """Launch ``steps`` fused zero-boundary stencil steps of ``spec``."""
    if u.ndim != spec.ndim or u.ndim not in (2, 3):
        raise ValueError(f"stencil kernel takes 2-D or 3-D u matching the "
                         f"spec, got {tuple(u.shape)} for {spec.ndim}-D")
    if not 1 <= spec.radius <= MAX_RADIUS or not 1 <= steps <= 3:
        raise ValueError(f"stencil kernel takes radius <= {MAX_RADIUS} and "
                         f"1 <= steps <= 3, got r={spec.radius} t={steps}")
    if spec.num_points > MAX_STENCIL_POINTS:
        raise ValueError(f"too many stencil points: {spec.num_points}")
    if spec.offsets != stencil_offsets(spec.ndim, spec.radius, spec.kind):
        raise ValueError(f"stencil {spec.name!r}: the kernels are compiled "
                         f"for the offsets of a {spec.kind} of radius "
                         f"{spec.radius} in kernels/stencil/defs.py order")
    _need(u, "stencil u", torch.float32)
    out = torch.empty_like(u)
    dims = (ctypes.c_int * 3)(*([1] * (3 - u.ndim) + list(u.shape)))
    offs = [0] * (3 * spec.num_points)
    for p, off in enumerate(spec.offsets):
        full = (0,) * (3 - u.ndim) + tuple(off)
        offs[3 * p:3 * p + 3] = full
    c_offs = (ctypes.c_int * len(offs))(*offs)
    c_w = (ctypes.c_float * spec.num_points)(*spec.weights)
    axw = [0.0] * (3 * (2 * MAX_RADIUS + 1))
    for ax, w1d in enumerate(spec.axis_weights):
        slot = ax + 3 - u.ndim
        axw[slot * 7:slot * 7 + len(w1d)] = w1d
    c_axw = (ctypes.c_float * len(axw))(*axw)
    with torch.cuda.device(out.device):
        code = _lib("stencil").stencil_launch(
            u.data_ptr(), out.data_ptr(), dims, u.ndim, c_offs, c_w,
            spec.num_points, c_axw, float(spec.center), spec.radius,
            int(spec.kind == "box"), int(steps), int(block_rows),
            int(engine == "matrix"), _stream(out))
    _check("stencil", code, f"stencil_{engine}")
    return out


#: Query heads per KV head the attention kernels take: two of the matrix
#: kernels' MMA N tiles of 8 (a head tile of 8 for G <= 8, of 16 above).
MAX_GROUP = 16
#: Head dims the attention kernels are instantiated for: every head dim of
#: the configs that decode through them (112: Zamba2-7B, 160: StableLM-2-12B)
#: and the reference tests' 16, 32 and 64.
HEAD_DIMS = (16, 32, 64, 112, 128, 160)


#: CTAs per SM for the kernels at a head tile of 8 (G <= 8), by dtype.  Both
#: stage K and V ahead of the compute through rings in shared memory
#: (bfloat16: each warp's cp.async ring, two tiles ahead; float32: the ring
#: kernels' TMA copies, issued by a producer warp to keep ~48 KB in flight),
#: so one CTA of four consumer warps per SM keeps HBM busy and runs best as
#: one long range (``attention_ranges`` takes two for short caches).
CTAS_PER_SM = {torch.bfloat16: 1, torch.float32: 1}


def ctas_per_sm(dtype: torch.dtype, g: int, engine: str) -> int:
    """CTAs per SM for one call: ``CTAS_PER_SM`` at a head tile of 8 (G <=
    8); at a head tile of 16 (G > 8) the slots each kernel's layout fits.

    float32 at G <= 8 takes one (the ring kernels): each CTA walks one long
    range, its producer warp keeping ~48 KB of K and V in flight.  Measured
    with ``tools/decode_audit.py --parts ptxas slots`` (NVIDIA H100 80GB
    HBM3, 700 W; ``PERF.md`` §6): at Mistral-NeMo's decode shape (B
    4, KH 8, G 4, S 32768, kv_len 28672) 1, 2, 3 and 4 slots per SM take
    318.7, 321.6, 325.3 and 322.8 us (vector) and 319.0, 321.6, 324.2 and
    322.4 us (matrix); the ring kernels use 72-250 registers (245 vector,
    158 matrix at Dh 128) and spill nothing.  ``attention_ranges`` takes
    two for short caches whose rings fit an SM twice.

    At G > 8 the bfloat16 vector kernel takes two: it is bound by FFMA
    issue (four times G = 4's FFMAs per cache byte); its 112 KB of shared
    memory and 255 registers fit two CTAs of four warps per SM, and one CTA
    per SM leaves one warp per scheduler to hide the latencies.  The
    float32 vector kernel takes one: its FFMA floor is 40% of its byte
    bound, so one warp per scheduler issues enough; its rings of 16 KB
    half-stages take 144 KB at Dh 128, so a second CTA per SM would only
    run as a second wave.  The float32 matrix kernel, which loads straight
    from global memory, takes two, and the bfloat16 matrix kernel one."""
    if g <= 8:
        return CTAS_PER_SM[dtype]
    if engine == "vector":
        return 2 if dtype == torch.bfloat16 else 1
    return 1 if dtype == torch.bfloat16 else 2


#: Shared memory of an SM that resident CTAs share, and the part of it the
#: system reserves for each CTA (H100).
SM_SHARED_BYTES = 228 * 1024
CTA_RESERVED_BYTES = 1024


def attention_ring(dh: int, tiles: int):
    """``(depth, bytes)``: the float32 ring kernels' stages a warp and
    dynamic shared memory for a range of ``tiles`` 16-position tiles a warp
    (``RingLayout`` in ``csrc/attention.cu``, which the launcher computes
    the same way): the fewest stages, at least two, that keep 48 KB of a
    CTA's tiles in flight beyond the ones being computed, within a block's
    227 KB, but no more than the range's tiles, and at least one."""
    tile = 2 * 16 * dh                       # floats: K's box, V's box
    aux = 4 * 16 * 8 + 2 * 4 * 8 + 8 * 4 * (dh // 4 + 4)
    max_depth = (227 * 1024 - 1024 - aux * 4) // (4 * (tile * 4 + 16))
    ring = min(max_depth, max(2, 1 + -(-48 * 1024 // (4 * tile * 4))))
    depth = max(1, min(ring, tiles))
    return depth, 1024 + (4 * depth * tile + aux) * 4 + 2 * 4 * depth * 8


def attention_split(s: int, block_s: int, pairs: int, slots: int,
                    end: Optional[int] = None):
    """``(rows, nsplit)``: positions ``[0, end)`` (default all of S) cut into
    ``nsplit`` ranges of ``rows``, one CTA each.

    Where the ``pairs = B * KH`` leave some of the card's ``slots`` CTA
    slots free, each pair's positions are cut into as many equal ranges (a
    multiple of 64 positions) as fill the slots once: one long range per
    CTA, so a CTA's start (its first tiles' latency) and end are paid once
    per slot.  Where the pairs alone fill the slots, each CTA takes one
    reference KV block of ``block_s`` positions, as one Pallas grid step
    did, and the many short CTAs balance across the waves.
    """
    if s <= 0 or block_s <= 0 or s % block_s:
        raise ValueError(f"block_s={block_s} must divide S={s}")
    end = s if end is None else end
    if pairs > slots:
        rows = block_s
    else:
        rows = -(-end // (slots // pairs))
        rows = -(-rows // 64) * 64
    return rows, -(-end // rows)


def attention_ranges(s: int, block_s: int, pairs: int, sms: int,
                     kv_len: int, dtype: torch.dtype, g: int,
                     engine: str, dh: int):
    """``(rows, nsplit, end)``: the CTAs one flash-decode call launches
    (``ctas_per_sm(dtype, g, engine)`` slots per SM).

    The kernels read cache positions ``[0, end)``: ``end = min(kv_len, S)``
    for ``kv_len >= 1``, and all of S for ``kv_len <= 0``, where the output
    is the mean of V.  A range wholly past ``kv_len`` would enter the merge
    with weight ``e^(-1e30 - m*) = 0``, so reading every position with the
    same ``rows`` (``end = S``) changes no bit of the result.

    The float32 ring kernels (G <= 8) take two slots per SM where the
    ranges cut for two leave each CTA a ring of at least two stages
    (``attention_ring`` at head dim ``dh``) that two CTAs fit in one SM: a
    short cache whose whole ranges sit in the ring, so that halving them
    halves each warp's serial tiles (SeamlessM4T's S 512 at Dh 64: 10.3
    against 12.0 us).  Elsewhere a ring fills a block, or a range of one
    tile a warp is mostly its CTA's start, and one slot stays best.
    """
    end = min(kv_len, s) if kv_len >= 1 else s
    rows, nsplit = attention_split(s, block_s, pairs,
                                   ctas_per_sm(dtype, g, engine) * sms, end)
    if dtype == torch.float32 and g <= 8:
        rows2, nsplit2 = attention_split(s, block_s, pairs, 2 * sms, end)
        depth, nbytes = attention_ring(dh, -(-min(rows2, end) // 64))
        if depth >= 2 and \
                2 * (nbytes + CTA_RESERVED_BYTES) <= SM_SHARED_BYTES:
            rows, nsplit = rows2, nsplit2
    return rows, nsplit, end


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_len: int, *, block_s: int, engine: str,
              split_pairs: Optional[int] = None) -> torch.Tensor:
    """Launch flash-decode: q (B, KH, G, Dh) over k, v (B, S, KH, Dh).

    ``split_pairs`` (default ``B * KH``) is the pair count whose split-S
    schedule the call runs: a head shard passes the unsharded call's, so
    its heads are cut into the same ranges and merged in the same order as
    in the unsharded call, and its output equals those heads' bit for bit.
    """
    b, kh, g, dh = q.shape
    s = k.shape[1]
    if k.ndim != 4 or tuple(k.shape) != (b, s, kh, dh) or \
            v.shape != k.shape:
        raise ValueError(f"flash-decode shapes disagree: q {tuple(q.shape)},"
                         f" k {tuple(k.shape)}, v {tuple(v.shape)}")
    dtype = q.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash-decode takes float32/bfloat16, got {dtype}")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"flash-decode takes 1..{MAX_GROUP} query heads per "
                         f"KV head, got {g}: a wider head group waits for "
                         f"ROADMAP.md Queue 2 item 2 (K4)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash-decode takes head dim in {HEAD_DIMS}, got "
                         f"{dh}: another head dim waits for ROADMAP.md "
                         f"Queue 2 item 7 (K4)")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _need(t, f"flash-decode {what}", dtype)
    pairs = b * kh if split_pairs is None else int(split_pairs)
    if pairs < b * kh:
        raise ValueError(f"split_pairs={pairs} is below this call's "
                         f"B * KH = {b * kh}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows, nsplit, end = attention_ranges(s, block_s, pairs, sms,
                                         int(kv_len), dtype, g, engine, dh)
    return attention_launch(q, k, v, int(kv_len), rows=rows, nsplit=nsplit,
                            end=end, engine=engine)


def attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: int, *, rows: int, nsplit: int, end: int,
                     engine: str) -> torch.Tensor:
    """Launch flash-decode over positions ``[0, end)`` cut into ``nsplit``
    ranges of ``rows``, on inputs that ``attention`` has checked.

    ``attention`` passes ``attention_ranges``' schedule; a check may pass
    the same ``rows`` with ``end = S`` and ``nsplit = ceil(S / rows)``, to
    read each position, masked or not.
    """
    b, kh, g, dh = q.shape
    s = k.shape[1]
    pairs = b * kh
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if nsplit > 1:
        part_ml = torch.empty(pairs * nsplit * g * 2, dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty(pairs * nsplit * g * dh, dtype=torch.float32,
                               device=q.device)
    # 1 / sqrt(Dh) rounded as the reference rounds it: both in float32
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    with torch.cuda.device(out.device):
        code = _lib("attention").attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            b, kh, g, s, dh, kv_len, end, rows, nsplit, scale,
            int(q.dtype == torch.bfloat16), int(engine == "matrix"),
            _stream(out))
    _check("attention", code, f"attention_{engine}")
    if q.dtype == torch.float32 and g <= 8:
        LAUNCHES[f"attention_ring_{engine}"] += 1
    return out
