#!/usr/bin/env python3
"""Drive the PyTorch / H100 port's main path on one NVIDIA card.

Four paths, through the port's public entry points.  The paper's
experiment: every kernel family (SCALE, STREAM Triad, AXPY, block-ELL
SpMV, Table-3 stencils, flash-decode attention) is classified by the §6
advisor, launched on the CUDA-core (vector) and the tensor-core (matrix)
kernel, timed with CUDA events, and its measured matrix/vector time
ratio printed beside the Eq. 23 ceiling.  Kernel serving: seeded
traffic of each family through the continuous-batching scheduler, the
elementwise requests packed into one launch per batch.  LM decode
serving: Mistral-NeMo-12B at full width and depth (random float32
weights from a seed) serves seeded traffic through the same scheduler,
every layer's decode attention through the flash-decode kernel.  Tile
tuning and the report: the tunable kernels' tiles searched on the card,
the STREAM sweep run again with the winners, SCALE / Triad / AXPY served
with an online tile bandit, and the whole record directory rendered as
REPORT.md and per-kernel pages.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device line (nvidia-smi name and power limit, HardwareSpec chosen);
  2. build of the hand-written kernels from src/repro_torch/kernels/csrc;
  3. each kernel against its plain PyTorch version on the card at small
     and odd shapes (float32 max-abs <= 1e-4, bfloat16 within one ulp):
     the elementwise kernels bit for bit at the edges of their grid (one
     CTA's elements -/+ 1, one full wave of resident CTAs and 8 elements
     more) for every tile of the space, and from a 16-byte offset; SpMV with
     slot counts off the ring depth and warp count, repeated and
     out-of-range ids; the stencils bit for bit, every suite member on both
     engines at block_rows None / 32 / 1, on trailing extents 1, 2 and 3
     mod 4 (the 4-byte load path), domains smaller than one tile, leading
     extents that no block divides, and a 3-D radius-3 star at t = 3 (the
     largest halo); flash-decode at kv_len edges where whole ranges lie
     past kv_len, each also bit for bit against reading every position;
  4. the experiment at STREAM size (every array >= 4x the 50 MiB L2):
     launch counts reset before it and read after it, one JSON line per
     point and engine, with the host's enqueue time and torch.profiler's
     device time per call, then each output held against its plain
     version (the stencils and the elementwise kernels bit for bit);
  5. library yardsticks (one PyTorch call computing the same function),
     and SpMV's byte bound in CSR;
  6. the paper's steps 4-5 through the port's own sweep and claims:
     repro_torch.bench.bench_kernels.records_for for every family at the
     reference's bench_sizes and at the STREAM points, launch counts reset
     before it and read after it; build/runs_torch/BENCH_<kernel>.json
     written, loaded back with repro_torch.report.load_dir and verified
     with check_records (one claims line, one line per violation: any
     violation, or a set that fails to load, is fatal); the tracer's
     overhead on one elementwise STREAM point (median captured against
     median without);
  7. kernel serving: one repro_torch.serving.run_session per family and
     engine on the card, at STREAM size (SCALE / Triad / AXPY requests of
     2^23 float32 elements, Poisson 4000 req/s, so a full batch of 8
     packs to phase 4's 2^26; SpMV, 2d5pt and float32 flash-decode
     requests at their STREAM points, Poisson 200 req/s; 0.5 virtual s,
     max_wait 20 ms, seed 0): launch counts reset before each session and
     read after it, held against the log (a packed family launches once
     per batch plus one warm-up, the others once per request plus one
     warm-up); one formed batch's packed output, and a batch of three
     ragged requests, sliced per request and held bit for bit against
     the kernel on each request's own input, the padding zero; one JSON
     line per session; build/runs_torch/BENCH_serve_<kernel>.json
     written, loaded back and verified with check_records (a violation
     is fatal); a packed batch's compute time inside and outside a trace
     capture;
  8. LM decode serving, once per flash-decode engine, through run_session
     (the reference's serve --workload lm traffic: Poisson 8 req/s for 1
     virtual s, max_batch 4, max_wait 20 ms, seed 0): launch counts reset
     before the session and read after it (one launch per layer and
     decode step of each logged batch and of the warm-up), one
     teacher-forced decode step held against the plain dense-attention
     path, prefill and per-step times; BENCH_serve_lm-mistral-nemo-12b.json
     written and verified, the model verdict at full width included;
  9. tile tuning: repro_torch.tuning.tune_op for SCALE / Triad / AXPY,
     the stencils and flash-decode on both engines at their STREAM
     points (phase 4's inputs), every candidate of the family's tile
     space timed by CUDA events; launch counts reset before and read
     after; one JSON line per search (winner, best_us, default_us and
     the default's IQR); build/runs_torch/tuned.json written (source
     "cuda") and read back.  A skipped candidate is fatal;
 10. the STREAM sweep again with those tiles
     (bench_kernels.records_for(..., tuned=)) into
     build/runs_torch_tuned/: every record of a tuned family carries its
     tile_config, the claims give 0 violations, and each point's tuned
     us_per_call is printed beside phase 6's untuned one;
 11. online-tuned serving: one session per elementwise family at phase
     7's traffic through OnlineKernelBatchExecutor (engine 'auto', the
     bandit warm-started from tuned.json): launches held against the
     log (one per batch plus one warm-up per arm pulled), the record's
     online_ceiling passing, BENCH_serve_<k>_online.json and
     tuned-online.json written;
 12. repro_torch.bench.compare with build/runs_torch as both baseline and
     candidate, which must pass (the regret gate joins the online pairs);
 13. repro_torch.report.write_report on build/runs_torch into
     build/runs_torch/REPORT.md and build/runs_torch/docs/benchmarks/,
     twice, byte-identical, the ceiling column at 0 violations;
 14. one JSON line of per-kernel numbers, then the result line.

Exits non-zero, printing no result, without a card or without the
repository's sources beside this file.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
#: Phase 4's order of the STREAM points.
STREAM_ORDER = ("scale", "triad", "axpy", "spmv", "stencil", "attention")
WARMUP, ITERS = 3, 20
F32_TOL = 1e-4            # report/claims.py's float32 accuracy claim
#: bfloat16 attention outputs are convex combinations of V rows, and some
#: elements cancel to near zero, where float32 summation error exceeds a
#: bf16 ulp of the element: the ulp there is taken at this fraction of the
#: output's largest magnitude.
ATTN_FLOOR = 1 / 256
#: Non-tensor float32 peak of an H100 SXM (NVIDIA datasheet), for the
#: operations side of each kernel's bound.
PEAK_OPS = 67e12

#: Float32 tolerance of the model phase's decode step against the plain
#: dense-attention path: the reference's own model tier
#: (tests/test_model_engine.py), elementwise |a - b| <= atol + rtol |b|.
STEP_RTOL, STEP_ATOL = 1e-3, 1e-4

#: (kernel family, engine) -> the TPU kernel it replaces (the function that
#: reaches pl.pallas_call) and the CUDA source.
REPLACES = {
    "scale": "src/repro/core/dispatch.py:475",
    "triad": "src/repro/core/dispatch.py:475",
    "axpy": "src/repro/core/dispatch.py:475",
    "spmv": "src/repro/kernels/spmv/spmv.py:60",
    "stencil": "src/repro/kernels/stencil/stencil.py:138",
    "attention": "src/repro/kernels/attention/flash_decode.py:70",
}
#: Kernel families whose points also print the host's enqueue time and
#: torch.profiler's device time: their kernels take 0.15-0.4 ms, near the
#: host's own time per call.
REDESIGNED = ("scale", "triad", "axpy", "spmv", "stencil", "attention")
#: Flops of one DMMA m8n8k4 (8 x 8 x 4 multiply-adds).
DMMA_FLOPS = 512
SOURCE = {
    "scale": "elementwise", "triad": "elementwise", "axpy": "elementwise",
    "spmv": "spmv", "stencil": "stencil", "attention": "attention",
}
#: The serving phase: one session per family and engine, Poisson traffic.
#: Elementwise requests of 2^23 float32 elements, so a full batch of 8
#: packs to phase 4's 2^26; the other families at their STREAM points.
PACKED = ("scale", "triad", "axpy")
SERVE_ELEMENTWISE, SERVE_ELEMENTWISE_RPS, SERVE_OTHER_RPS = 2**23, 4000.0, 200.0
SERVE_MAX_BATCH, SERVE_MAX_WAIT_S, SERVE_DURATION_S = 8, 0.02, 0.5
#: The LM decode phase: Mistral-NeMo-12B, full width and depth, float32.
MODEL = "mistral-nemo-12b"
MODEL_BATCH, PROMPT_LEN, MAX_GEN = 4, 496, 16
#: Its traffic: the reference's ``serve --workload lm`` defaults.
LM_RPS, LM_DURATION_S, LM_SLO_MS = 8.0, 1.0, 30000.0
#: The families with a tile space, tuned on both engines in phase 9.
TUNED = ("scale", "triad", "axpy", "stencil", "attention")
#: The online bandit's exploration pulls per key (the reference's default).
ONLINE_BUDGET = 8


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

    from repro_torch.bench.bench_kernels import bound_work, stream_points
    from repro_torch.bench.common import card_line
    from repro_torch.core.bounds import tensor_core_upper_bound
    from repro_torch.core.dispatch import elementwise_call, elementwise_plain
    from repro_torch.core.hw import spec_for_device_name
    from repro_torch.core.timing import time_fn
    from repro_torch.kernels import _ext, registry
    from repro_torch.kernels.elementwise_tuning import ELEMENTWISE_TILE_SPACE
    from repro_torch.kernels.attention.flash_decode import flash_decode_plain
    from repro_torch.kernels.attention.ops import (DEFAULT_BLOCK_S,
                                                   _clamp_block_s)
    from repro_torch.kernels.spmv.ref import dense_to_bell
    from repro_torch.kernels.spmv.spmv import bell_spmv, spmv_plain
    from repro_torch.kernels.stencil.defs import TABLE3_DEPTH, _star, suite
    from repro_torch.kernels.stencil.stencil import stencil_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    # -- 1. device ---------------------------------------------------------
    card = card_line()
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
        if name == "attention":
            q, k, v, kv_len = args
            bs = _clamp_block_s(k.shape[1], kw.get("block_s")
                                or DEFAULT_BLOCK_S)
            return flash_decode_plain(q, k, v, kv_len, block_s=bs,
                                      engine=engine)
        u, spec = args
        return stencil_plain(u, spec, steps=kw["steps"], engine=engine)

    def err_and_tol(got, want, tol_f32, floor=0.0):
        """max-abs error and whether it is within tolerance.  bfloat16:
        one ulp of each element, with the ulp taken at ``floor`` times the
        output's largest magnitude where the element is smaller."""
        err = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
        if got.dtype == torch.bfloat16:
            mag = want.float().abs()
            mag = mag.clamp_min(max(floor * mag.max().item(), 1e-30))
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            ok = bool(((got.float() - want.float()).abs() <= ulp).all())
        else:
            ok = err <= tol_f32
        return err, ok and got.shape == want.shape and got.dtype == want.dtype

    def check(tag, got, want, tol_f32=F32_TOL, floor=0.0):
        torch.cuda.synchronize()
        err, ok = err_and_tol(got, want, tol_f32, floor)
        if not ok:
            failures.append(f"{tag}: max_abs_err {err}")
        return err

    # tensor-core instructions in the built SASS: every matrix kernel
    # issues DMMA/HMMA, no vector kernel does
    sass = {}
    for symbol, ops in _ext.mma_instructions().items():
        # stencil_kernel<ndim, radius, box, matrix>
        match = re.search(r"(elementwise|spmv|stencil|attention)_"
                          r"(?:(vector|matrix)_)?kernel"
                          r"(?:ILb[01]ELb[01]ELb([01])E|ILb([01])E|"
                          r"ILi[23]ELi[1-3]ELb[01]ELb([01])E)?",
                          symbol)
        if match is None:
            continue
        family, named, ew_mma, mma_flag, st_mma = match.groups()
        matrix = named == "matrix" or "1" in (ew_mma, mma_flag, st_mma)
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
    if len(sass) != 8:
        failures.append(f"SASS audit found {sorted(sass)}, expected the "
                        f"eight family/engine kernels")

    # -- 3. kernels against their plain versions on the card ---------------
    n_checks = 0
    for op in registry.all_ops():
        for dtype in op.dtypes:
            args, kw = op.make_inputs(np.random.default_rng(SEED),
                                      op.test_size, dtype)
            for engine in ("vector", "matrix"):
                check(f"{op.name}/{engine}/{dtype}@test_size",
                      op(*args, engine=engine, **kw),
                      plain_of(op.name, args, kw, engine),
                      floor=ATTN_FLOOR if op.name == "attention" else 0.0)
                n_checks += 1
            advice = op.advice(*args, **kw)
            before = _ext.LAUNCHES[f"{op.name}_vector"]
            op(*args, engine="auto", **kw)
            if advice.engine != "vector" or \
                    _ext.LAUNCHES[f"{op.name}_vector"] != before + 1:
                failures.append(f"{op.name}/{dtype}: engine='auto' did not "
                                f"route to the vector kernel")
    gen = torch.Generator().manual_seed(SEED)
    # the elementwise grid's edges, bit for bit, for every tile of the
    # space: one CTA's elements -/+ 1, one full wave of the card's resident
    # CTAs and 8 elements more, beside odd sizes; and an input that starts
    # 16 bytes into a larger tensor
    props = torch.cuda.get_device_properties(0)
    wave = props.multi_processor_count * (
        props.max_threads_per_multi_processor // _ext.ELEMENTWISE_THREADS)
    for dtype in (torch.float32, torch.bfloat16):
        per_chunk = 16 // torch.tensor([], dtype=dtype).element_size()
        cta = _ext.ELEMENTWISE_THREADS * per_chunk
        for has_add in (False, True):
            for shape in ((17,), (cta - 1,), (cta + 1,), (wave * cta,),
                          (wave * cta + 8,), (300_000,), (33, 95)):
                m = torch.randn(shape, generator=gen).to(dtype).cuda()
                a = torch.randn(shape, generator=gen).to(dtype).cuda() \
                    if has_add else None
                for engine in ("vector", "matrix"):
                    want = elementwise_plain(m, 1.5, a, engine)
                    for rows in ELEMENTWISE_TILE_SPACE["block_rows"]:
                        for lanes in ELEMENTWISE_TILE_SPACE["lanes"]:
                            got = elementwise_call("tail", m, 1.5, a,
                                                   engine=engine,
                                                   block_rows=rows,
                                                   lanes=lanes)
                            n_checks += 1
                            if not torch.equal(got, want):
                                failures.append(
                                    f"elementwise/{engine}/{dtype}/{shape}/"
                                    f"add={has_add}/tile {rows}x{lanes}: "
                                    f"not equal to the plain version")
            big = torch.randn(300_000 + per_chunk,
                              generator=gen).to(dtype).cuda()
            m = big[per_chunk:]
            a = big[:-per_chunk] if has_add else None
            for engine in ("vector", "matrix"):
                n_checks += 1
                if not torch.equal(elementwise_call("tail", m, 1.5, a,
                                                    engine=engine),
                                   elementwise_plain(m, 1.5, a, engine)):
                    failures.append(f"elementwise/{engine}/{dtype}/add="
                                    f"{has_add}: input at a 16-byte offset "
                                    f"not equal to the plain version")
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
    # block rows whose slot count is no multiple of the matrix kernel's ring
    # depth (3) or of the four warps, one block row, repeated column ids and
    # out-of-range ids (which contribute nothing: the plain version gets
    # those slots as zero blocks at column 0)
    for nbr, mb, ncb in ((1, 1, 1), (1, 7, 3), (5, 13, 4), (3, 2, 2)):
        blocks = torch.randn((nbr, mb, 8, 128), generator=gen).cuda()
        cols = torch.randint(0, ncb, (nbr, mb), generator=gen,
                             dtype=torch.int32).cuda()
        if mb > 1:
            cols[:, 1] = cols[:, 0]                        # a repeated id
        x = torch.randn(ncb * 128, generator=gen).cuda()
        bad = torch.zeros((nbr, mb), dtype=torch.bool, device="cuda")
        if mb > 2:
            cols[0, 2], cols[-1, mb - 1] = ncb, -1         # out of range
            bad[0, 2] = bad[-1, mb - 1] = True
        for engine in ("vector", "matrix"):
            check(f"spmv/{engine}/blocks{nbr}x{mb}/ncb{ncb}",
                  bell_spmv(blocks, cols, x, engine=engine),
                  spmv_plain(blocks.masked_fill(bad[:, :, None, None], 0.0),
                             cols.masked_fill(bad, 0), x, engine=engine))
            n_checks += 1
    # the stencils bit for bit: the kernels sum in the plain version's order.
    # Per ndim: the trailing extent 0 mod 4 (16-byte loads) and 3, 1 mod 4
    # (4-byte loads); leading extents that no block divides; a domain
    # smaller than one tile; and a 3-D radius-3 star at t = 3
    stencil_op = registry.get("stencil")
    stencil_cases = []
    for name, spec in sorted(suite().items()):
        for shape in ([(1000, 1000), (1001, 1003), (5, 9)] if spec.ndim == 2
                      else [(96, 96, 96), (97, 95, 99), (3, 4, 5)]):
            stencil_cases.append((name, spec, TABLE3_DEPTH[name], shape))
    stencil_cases.append(("3d_star_r3", _star("3d_star_r3", 3, 3,
                                              (0.11, 0.05, 0.02), 0.28),
                          3, (37, 45, 50)))
    stencil_cases.append(("2d5pt", suite()["2d5pt"], 3, (130, 1002)))
    for name, spec, steps, shape in stencil_cases:
        u = torch.randn(shape, generator=gen).cuda()
        # the default block, a 32-row block, and one below the halo that
        # the t*r clamp lifts
        for block_rows in (None, 32, 1):
            for engine in ("vector", "matrix"):
                got = stencil_op(u, spec, steps=steps, engine=engine,
                                 block_rows=block_rows)
                want = stencil_plain(u, spec, steps=steps, engine=engine)
                n_checks += 1
                if not torch.equal(got, want):
                    failures.append(
                        f"stencil/{name}/{engine}/{shape}/block_rows="
                        f"{block_rows}: not equal to the plain version, "
                        f"max_abs_err {(got - want).abs().max().item()}")
    attention_op = registry.get("attention")
    # tests/test_flash_decode.py's shapes (b, s, kh, g, dh) at kv_len =
    # S - 16, its unaligned serving lengths, and an all-masked cache
    attn_cases = [(b, s, kh, g, dh, s - 16) for b, s, kh, g, dh in
                  ((1, 512, 2, 4, 64), (2, 1024, 4, 8, 128),
                   (1, 256, 1, 1, 32))]
    attn_cases += [(2, s, 1, 2, 16, kv) for s, kv in ((12, 9), (24, 24),
                                                      (56, 1))]
    attn_cases += [(1, 512, 2, 4, 64, 0)]
    for b, s, kh, g, dh, kv_len in attn_cases:
        qkv = [torch.randn(shape, generator=gen).cuda() for shape in
               ((b, kh, g, dh), (b, s, kh, dh), (b, s, kh, dh))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in qkv)
            for block_s in (128, 256, 512):
                for engine in ("vector", "matrix"):
                    check(f"attention/{engine}/{dtype}/b{b}s{s}kh{kh}g{g}"
                          f"dh{dh}/kv_len={kv_len}/block_s={block_s}",
                          attention_op(q, k, v, kv_len, engine=engine,
                                       block_s=block_s),
                          plain_of("attention", (q, k, v, kv_len),
                                   {"block_s": block_s}, engine),
                          floor=ATTN_FLOOR)
                    n_checks += 1
    # flash-decode where whole ranges lie past kv_len: (b, s, kh, g, dh) =
    # (2, 1024, 2, 4, 128) cuts the cache into ranges of 64 positions. Each
    # kv_len >= 1 is also held bit for bit against the same kernel reading
    # every range and position (end = S), as the reference does.
    b, s, kh, g, dh, block_s = 2, 1024, 2, 4, 128, 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    qkv = [torch.randn(shape, generator=gen).cuda() for shape in
           ((b, kh, g, dh), (b, s, kh, dh), (b, s, kh, dh))]
    for kv_len in (0, 1, 15, 16, 17, 63, 64, 65, s - 1, s):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in qkv)
            rows = _ext.attention_ranges(s, block_s, b * kh, sms, kv_len,
                                         dtype)[0]
            for engine in ("vector", "matrix"):
                tag = (f"attention/{engine}/{dtype}/kv_len={kv_len} of {s} "
                       f"in ranges of {rows}")
                got = attention_op(q, k, v, kv_len, engine=engine,
                                   block_s=block_s)
                check(tag, got, plain_of("attention", (q, k, v, kv_len),
                                         {"block_s": block_s}, engine),
                      floor=ATTN_FLOOR)
                n_checks += 1
                if kv_len >= 1:
                    full = _ext.attention_launch(q, k, v, kv_len, rows=rows,
                                                 nsplit=-(-s // rows), end=s,
                                                 engine=engine)
                    torch.cuda.synchronize()
                    if not torch.equal(got, full):
                        failures.append(f"{tag}: differs from the full read "
                                        f"by {(got - full).abs().max()}")
                    n_checks += 1
    print(f"kernel checks: {n_checks} against the plain versions, "
          f"{len(failures)} failed", flush=True)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- 4. the experiment at STREAM size ----------------------------------
    # the points of repro_torch.bench.bench_kernels.stream_points, which
    # the sweep of phase 6 records too
    points = []
    rng = np.random.default_rng(SEED)
    for op in registry.all_ops():
        for pt in stream_points(op, rng, "cuda"):
            point, shape = _point_label(op.name, pt)
            points.append((op, point, pt.dtype, shape, pt.args, pt.kwargs))
    points.sort(key=lambda p: STREAM_ORDER.index(p[0].name))
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
            times[engine] = time_fn(lambda: op(*args, engine=engine, **kw),
                                    warmup=WARMUP, iters=ITERS)
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
        traffic, work = bound_work(op.name, args, traits)
        bytes_s = traffic / hw.mem_bw
        ops_s = work / PEAK_OPS
        bound_ms = max(bytes_s, ops_s) * 1e3
        # the advisor's bound, over every stored block or cache position
        traits_ms = traits.traffic_bytes / hw.mem_bw * 1e3
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
        floor = ATTN_FLOOR if op.name == "attention" else 0.0
        plain_t = {}
        for engine in ("vector", "matrix"):
            want = plain_of(op.name, args, kw, engine)
            err = check(f"{point}/{engine} at full size", outs[engine], want,
                        tol, floor)
            if op.name == "stencil" and not torch.equal(outs[engine], want):
                failures.append(f"{point}/{engine} at full size: not equal "
                                f"to the plain version")
            plain_t[engine] = time_fn(plain_of, op.name, args, kw, engine,
                                      warmup=1, iters=5)
            t = times[engine]
            line = {
                "point": point, "kernel": op.name, "engine": engine,
                "dtype": dtype, "shape": list(shape),
                "median_us": t.median_us, "iqr_us": t.iqr_us,
                "iters": t.iters,
                "GB/s": traffic / t.median_us / 1e3,
                "bw_share": traffic / (t.median_us * 1e-6) / hw.mem_bw,
                "engine_auto": advice.engine,
                "max_speedup_matrix": advice.max_speedup_matrix,
                "matrix_over_vector_time": ratio,
                "eq23_ceiling": ceiling,
                "card": card,
            }
            if op.name == "attention":
                line["bound_all_positions_ms"] = traits_ms
            if op.name == "stencil" and engine == "matrix":
                line["dmma_floor_ms"] = _dmma_floor_ms(args, kw, hw)
            if op.name in REDESIGNED:
                # the host's enqueue time per call beside the CUDA-event
                # median, and the kernels' device time from torch.profiler
                host_us, device_us = _host_and_device_us(
                    torch, lambda: op(*args, engine=engine, **kw))
                line["host_enqueue_us"] = host_us
                line["profiler_device_us"] = device_us
            print(json.dumps(line), flush=True)
            rows.append({"name": f"{op.name}_{engine}", "point": point,
                         "dtype": dtype, "err": err, "t": t,
                         "plain": plain_t[engine], "bound_ms": bound_ms,
                         "bound_by": bound_by, "op": op.name,
                         "traits_ms": traits_ms,
                         "dmma_floor_ms": line.get("dmma_floor_ms")})
        check(f"{point}/auto at full size", outs["auto"],
              outs[advice.engine], 0.0)

    # -- 5. library yardsticks -------------------------------------------
    library = {}
    for (op, point, dtype, shape, args, kw, *_rest) in results:
        library[point] = _library_ms(torch, F, op.name, args, kw, time_fn)
        if op.name == "spmv":
            # the same matrix in CSR: the bytes a CSR SpMV must move
            bell, x = args
            csr_ms = _csr_bytes(bell, x) / hw.mem_bw * 1e3
            print(json.dumps({"point": point, "library_ms": library[point],
                              "csr_bound_ms": csr_ms, "card": card}),
                  flush=True)
    del points, results, args, kw, outs, times, want, traits, bell, x, xg
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 6. BENCH records, verified by the claims layer ----------------------
    sweep_launches = _records_phase(torch, hw, card, failures)
    torch.cuda.empty_cache()

    # -- 7. kernel serving through the scheduler ----------------------------
    # phase 4's float32 medians (the 2d5pt one for the stencils), beside
    # which each serving session prints its compute p50
    stream_ms = {}
    for r in rows:
        if r["dtype"] == "float32":
            stream_ms.setdefault(r["name"], r["t"].median_us / 1e3)
    serving_launches = _serving_phase(torch, card, failures, stream_ms)
    torch.cuda.empty_cache()

    # -- 8. LM decode serving at full width through the scheduler ------------
    model_launches = _model_phase(torch, hw, card, failures)

    # -- 9. tile tuning on the card ---------------------------------------
    cache, tune_launches = _tune_phase(torch, hw, card, failures)
    torch.cuda.empty_cache()

    # -- 10. the STREAM sweep with the tuned tiles -------------------------
    tuned_launches = _tuned_sweep_phase(torch, hw, card, failures, cache)
    torch.cuda.empty_cache()

    # -- 11. online-tuned kernel serving ------------------------------------
    online_launches = _online_phase(torch, card, failures)
    torch.cuda.empty_cache()

    # -- 12. the compare gate -----------------------------------------------
    from repro_torch.bench import compare
    runs = str(ROOT / "build" / "runs_torch")
    gate_rc = compare.main([runs, runs])
    print(json.dumps({"compare": {"baseline": "build/runs_torch",
                                  "candidate": "build/runs_torch",
                                  "rc": gate_rc}}), flush=True)
    if gate_rc != 0:
        failures.append(f"compare gate on build/runs_torch: rc {gate_rc}")

    # -- 13. the report -----------------------------------------------------
    _report_phase(card, failures)

    # -- 14. the per-kernel line ---------------------------------------------
    kernels = []
    for r in rows:
        entry = {
            "name": r["name"], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCE[r['op']]}.cu",
            "replaces": REPLACES[r["op"]],
            "launches": launches.get(r["name"], 0),
            "sweep_launches": sweep_launches.get(r["name"], 0),
            "serving_launches": serving_launches.get(r["name"], 0),
            "tune_launches": tune_launches.get(r["name"], 0),
            "tuned_sweep_launches": tuned_launches.get(r["name"], 0),
            "online_serving_launches": online_launches.get(r["name"], 0),
            "max_abs_err": r["err"],
            "ms": r["t"].median_us / 1e3,
            "plain_ms": r["plain"].median_us / 1e3,
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": library[r["point"]],
            "point": r["point"], "dtype": r["dtype"],
        }
        if r["op"] == "spmv":
            entry["csr_bound_ms"] = csr_ms
        if r["op"] == "attention":
            entry["bound_all_positions_ms"] = r["traits_ms"]
        if r["name"] == "stencil_matrix":
            entry["dmma_floor_ms"] = r["dmma_floor_ms"]
        if r["op"] == "attention":
            # flash-decode's own main path is LM decode serving (phase 7)
            entry["experiment_launches"] = entry["launches"]
            entry["launches"] = model_launches[r["name"]]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _serving_phase(torch, card, failures, stream_ms):
    """Every family serves seeded traffic through run_session on the card.

    Per family, one session per engine on the same inputs; the launch
    counts of each session are held against its log, and the records
    written to build/runs_torch and verified.  Returns the launches per
    kernel ("scale_vector", ...) of its own session.
    """
    import numpy as np

    from repro_torch.bench.bench_kernels import stream_points
    from repro_torch.bench.common import bench_env, write_serving_json
    from repro_torch.core.dispatch import DEFAULT_DISPATCHER
    from repro_torch.kernels import _ext, registry
    from repro_torch.obs.trace import TRACER
    from repro_torch.report import check_records, load_file, violations
    from repro_torch.serving import (BatchPolicy, KernelBatchExecutor,
                                     SessionConfig, run_session)

    out_dir = str(ROOT / "build" / "runs_torch")
    env = bench_env("cuda", DEFAULT_DISPATCHER.hw.name)
    policy = BatchPolicy(max_batch=SERVE_MAX_BATCH,
                         max_wait_s=SERVE_MAX_WAIT_S)
    launches, by_claim, t_phase = {}, {}, time.perf_counter()
    gc_pauses = _GcPauses()
    for name in STREAM_ORDER:
        op = registry.get(name)
        rng = np.random.default_rng(SEED)
        if name in PACKED:
            size, rate = SERVE_ELEMENTWISE, SERVE_ELEMENTWISE_RPS
            args, kw = op.make_inputs(rng, size, "float32", "cuda")
        else:
            # the family's float32 STREAM point (the 2d5pt one)
            pt = next(stream_points(op, rng, "cuda"))
            size, rate, args, kw = (pt.size, SERVE_OTHER_RPS, pt.args,
                                    pt.kwargs)
        records = []
        for engine in ("vector", "matrix"):
            other = "matrix" if engine == "vector" else "vector"
            ex = KernelBatchExecutor(engine, max_batch=SERVE_MAX_BATCH,
                                     seed=SEED)
            ex.use_inputs(name, size, "float32", args, kw)
            cfg = SessionConfig(kernel=name, workload="poisson",
                                engine=engine, rate_rps=rate,
                                duration_s=SERVE_DURATION_S, size=size,
                                seed=SEED, policy=policy)
            torch.cuda.synchronize()
            _ext.reset_launches()
            events_before = len(TRACER.events)
            gc_pauses.reset()
            t0 = time.perf_counter()
            log, summary, record = run_session(cfg, executor=ex)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = dict(_ext.LAUNCHES)
            got = counts.get(f"{name}_{engine}", 0)
            launches[f"{name}_{engine}"] = got
            # one warm-up launch per session: every request has one size,
            # so every packed batch has one capacity
            want = (len(log.batches) if name in PACKED
                    else log.completed) + 1
            tag = f"serving/{name}/{engine}"
            if got != want or counts.get(f"{name}_{other}", 0):
                failures.append(f"{tag}: {got} {engine} and "
                                f"{counts.get(f'{name}_{other}', 0)} {other} "
                                f"launches, expected {want} and 0")
            if log.completed != log.offered or record["engine"] != engine:
                failures.append(f"{tag}: {log.completed}/{log.offered} "
                                f"served, engine {record['engine']}")
            print(json.dumps({
                "phase": "serving", "kernel": name, "engine": engine,
                "engine_auto": record["engine_auto"], "size": size,
                "rate_rps": rate, "offered": log.offered,
                "completed": log.completed, "batches": summary.batches,
                "mean_batch": summary.mean_batch, "p50_ms": summary.p50_ms,
                "p99_ms": summary.p99_ms,
                "compute_p50_ms": summary.compute_p50_ms,
                "compute_p99_ms": summary.compute_p99_ms,
                "compute_max_ms": max(b[4] for b in log.batches) * 1e3,
                "stream_median_ms": stream_ms.get(f"{name}_{engine}"),
                "goodput_rps": summary.goodput_rps,
                "slo_attainment": summary.slo_attainment,
                "launches": got, "wall_s": wall_s,
                "tracer_events_before": events_before,
                "gc_full_collections": len(gc_pauses.ms),
                "gc_full_max_ms": max(gc_pauses.ms, default=0.0),
                "card": card}),
                flush=True)
            records.append(record)
            if name in PACKED:
                _packed_checks(torch, op, ex, log, engine, args, size, tag,
                               failures)
            if name == "scale" and engine == "vector":
                _trace_cost(ex, log, card)
            del ex, log
        path = write_serving_json(name, records, out_dir, env=env)
        del args, kw
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        try:
            results = check_records([load_file(path)])
        except (OSError, ValueError, NotImplementedError) as exc:
            failures.append(f"serving records of {name}: {exc}")
            continue
        for r in results:
            c = by_claim.setdefault(r.claim, {"checked": 0,
                                              "violations": 0})
            c["checked"] += 1
            c["violations"] += int(not r.passed)
        for r in violations(results):
            failures.append(f"serving claim {r.claim} violated by "
                            f"{r.record.kernel}/{r.record.engine}: "
                            f"{r.detail}")
    gc_pauses.close()
    print(json.dumps({"serving_claims": by_claim,
                      "phase_s": time.perf_counter() - t_phase,
                      "card": card}), flush=True)
    return launches


class _GcPauses:
    """Durations (ms) of the interpreter's full (generation 2) garbage
    collections since the last reset: a host pause inside a timed batch
    shows in its compute time."""

    def __init__(self):
        import gc
        self.ms, self._t0 = [], None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms.append((time.perf_counter() - self._t0) * 1e3)
            self._t0 = None

    def reset(self):
        self.ms = []

    def close(self):
        import gc
        gc.callbacks.remove(self._on_gc)


def _packed_checks(torch, op, ex, log, engine, args, size, tag, failures):
    """The packed launch, sliced per request, bit for bit against the
    kernel on each request's own input, the padding zero: for the first
    formed batch of the session, and for three ragged requests with
    inputs of their own."""
    import numpy as np

    from repro_torch.serving import Request

    first = [r.request for r in log.results if r.batch_id == 0]
    own = {size: op(*args, engine=engine)}
    ragged = []
    rng = np.random.default_rng(SEED + 1)
    for i, n in enumerate((size - 3, 1000, 8)):
        a, kw = op.make_inputs(rng, n, "float32", "cuda")
        ex.use_inputs(op.name, n, "float32", a, kw)
        own[n] = op(*a, engine=engine, **kw)
        ragged.append(Request(rid=i, kernel=op.name, arrival_s=0.0, size=n))
    for label, batch in (("first batch", first), ("ragged batch", ragged)):
        out, sizes = ex.packed_call(batch)
        torch.cuda.synchronize()
        off = 0
        for n in sizes:
            if not torch.equal(out[off:off + n], own[n]):
                failures.append(f"{tag}: {label}, request of {n} at "
                                f"{off}: packed output differs from the "
                                f"kernel on its own input")
            off += n
        if bool((out[off:] != 0).any()):
            failures.append(f"{tag}: {label}: padding not zero")


def _trace_cost(ex, log, card):
    """A packed batch's compute time inside and outside a trace capture,
    20 executions each, twice in turns: the traced launch span
    synchronizes and computes a roofline sample inside the timed
    window."""
    import numpy as np

    from repro_torch.obs.trace import capture

    batch = [r.request for r in log.results if r.batch_id == 0]
    times = {False: [], True: []}
    for traced in (False, True, False, True):
        if traced:
            with capture():
                times[True] += [ex.execute(batch).compute_s
                                for _ in range(20)]
        else:
            times[False] += [ex.execute(batch).compute_s for _ in range(20)]
    untraced = float(np.median(times[False])) * 1e3
    traced = float(np.median(times[True])) * 1e3
    print(json.dumps({"phase": "serving_trace_cost", "kernel": "scale",
                      "engine": "vector", "batch": len(batch),
                      "untraced_compute_ms": untraced,
                      "traced_compute_ms": traced,
                      "traced_minus_untraced_ms": traced - untraced,
                      "calls": len(times[False]), "card": card}),
          flush=True)


def _model_phase(torch, hw, card, failures):
    """Mistral-NeMo-12B serves seeded traffic through run_session, once
    per flash-decode engine.

    Full width and depth (40 layers, d_model 5120, 32 query heads over 8
    KV heads), random float32 weights from SEED: about 49 GB on the card.
    The two sessions' records are written to build/runs_torch and
    verified.  Returns the flash-decode launches of the sessions, per
    kernel.
    """
    from repro_torch.bench.common import bench_env, write_serving_json
    from repro_torch.configs import get_arch
    from repro_torch.core.dispatch import DEFAULT_DISPATCHER
    from repro_torch.core.timing import busy_us
    from repro_torch.kernels import _ext
    from repro_torch.models.advisor_map import step_traits
    from repro_torch.models.engine import DecodeEngine
    from repro_torch.report import check_records, load_file, violations
    from repro_torch.serving import (SLO, BatchPolicy, PoissonLoadGen,
                                     SessionConfig, run_session)
    from repro_torch.serving.lm import LMDecodeExecutor

    cfg = get_arch(MODEL)
    steps = MAX_GEN - 1                 # decode steps per generation
    per_gen = cfg.n_layers * steps      # flash-decode launches per generation
    max_len = PROMPT_LEN + MAX_GEN
    step_bytes = step_traits(cfg, MODEL_BATCH, max_len,
                             dtype_bytes=4).traffic_bytes
    step_bound_ms = step_bytes / hw.mem_bw * 1e3
    print(f"model: {cfg.name} at full width and depth ({cfg.n_layers} layers,"
          f" d_model {cfg.d_model}, {cfg.n_heads} query / {cfg.n_kv_heads} KV"
          f" heads, head_dim {cfg.head_dim}, {cfg.param_count() / 1e9:.2f} B"
          f" float32 parameters), batch {MODEL_BATCH}, prompt {PROMPT_LEN}, "
          f"{MAX_GEN} tokens, cache {max_len}", flush=True)
    kernel = f"lm-{cfg.name}"
    launches, tokens, records = {}, {}, []
    for engine in ("vector", "matrix"):
        other = "matrix" if engine == "vector" else "vector"
        t0 = time.perf_counter()
        ex = LMDecodeExecutor(cfg, max_batch=MODEL_BATCH,
                              prompt_len=PROMPT_LEN, max_gen=MAX_GEN,
                              dtype=torch.float32, seed=SEED, engine=engine,
                              verdict_cfg=cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        mem_gb = torch.cuda.memory_allocated() / 1e9
        # the main path: the reference's serve --workload lm traffic
        # through the scheduler; the first batch also runs one untimed
        # warm-up generation
        session = SessionConfig(
            kernel=kernel, workload="lm", engine=engine, rate_rps=LM_RPS,
            duration_s=LM_DURATION_S, size=MAX_GEN, seed=SEED,
            policy=BatchPolicy(max_batch=MODEL_BATCH,
                               max_wait_s=SERVE_MAX_WAIT_S),
            slo=SLO(latency_ms=LM_SLO_MS))
        source = PoissonLoadGen(kernel=kernel, rate_rps=LM_RPS,
                                size=MAX_GEN, seed=SEED)
        _ext.reset_launches()
        t0 = time.perf_counter()
        log, summary, record = run_session(session, executor=ex,
                                           source=source)
        torch.cuda.synchronize()
        session_s = time.perf_counter() - t0
        counts = dict(_ext.LAUNCHES)
        launches[f"attention_{engine}"] = counts.get(f"attention_{engine}", 0)
        launches.setdefault(f"attention_{other}", 0)
        want = (len(log.batches) + 1) * per_gen
        if launches[f"attention_{engine}"] != want:
            failures.append(
                f"model/{engine}: {launches[f'attention_{engine}']} "
                f"flash-decode launches for {len(log.batches)} batches, "
                f"expected {want} (one per layer and decode step of each "
                f"batch and of the warm-up)")
        if counts.get(f"attention_{other}", 0):
            failures.append(f"model/{engine}: the {other} kernel ran "
                            f"{counts[f'attention_{other}']} times")
        if record["engine"] != engine or log.completed != log.offered:
            failures.append(f"model/{engine}: engine {record['engine']}, "
                            f"{log.completed}/{log.offered} served")
        records.append(record)
        extras = record["phases"]
        per_step_ms = extras["per_step_ms"]
        prefill_ms = extras["prefill_ms"] / extras["launches"]
        print(json.dumps({
            "phase": "model_serving", "kernel": kernel, "engine": engine,
            "offered": log.offered, "completed": log.completed,
            "batches": summary.batches, "mean_batch": summary.mean_batch,
            "p50_ms": summary.p50_ms, "p99_ms": summary.p99_ms,
            "queue_p50_ms": summary.queue_p50_ms,
            "compute_p50_ms": summary.compute_p50_ms,
            "goodput_rps": summary.goodput_rps,
            "slo_attainment": summary.slo_attainment,
            "per_step_ms": per_step_ms, "prefill_ms": prefill_ms,
            "memory_bound_time_frac":
                record["verdict"]["memory_bound_time_frac"],
            "flash_decode_launches": launches[f"attention_{engine}"],
            "session_s": session_s, "card": card}), flush=True)

        # greedy tokens of the main path's prompt batch
        eng = ex.engine
        batch = eng.make_prompt_batch(seed=SEED)
        result = eng.generate(batch)
        # the same generation outside the session's trace capture, where
        # no launch span synchronizes
        untraced_step_ms = result.per_step_s * 1e3
        tokens[engine] = result.tokens.cpu()
        if tuple(result.tokens.shape) != (MODEL_BATCH, MAX_GEN) or \
                not bool(torch.isfinite(result.logits).all()):
            failures.append(f"model/{engine}: tokens "
                            f"{tuple(result.tokens.shape)}, finite logits "
                            f"{bool(torch.isfinite(result.logits).all())}")
        del result

        # one teacher-forced step through the kernel against the plain
        # dense-attention path: same weights, caches and token
        logits, caches = eng.prefill(batch)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        twin = {"attn": {n: t.clone() for n, t in caches["attn"].items()}}
        got, _ = eng.decode_step(tok, caches, PROMPT_LEN)
        dense = DecodeEngine(cfg, max_batch=MODEL_BATCH,
                             prompt_len=PROMPT_LEN, max_gen=MAX_GEN,
                             dtype=torch.float32, engine=engine,
                             attention_impl="dense", params=eng.params)
        want, _ = dense.decode_step(tok, twin, PROMPT_LEN)
        step_err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=STEP_RTOL, atol=STEP_ATOL):
            failures.append(f"model/{engine}: decode step differs from the "
                            f"dense path by {step_err}")

        # where a decode step's time goes: one more step under
        # torch.profiler, device time summed by kernel
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.decode_step(torch.argmax(got[:, 0], dim=-1)[:, None], caches,
                            PROMPT_LEN + 1)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
        kernel_us = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernel_us[e.key] = kernel_us.get(e.key, 0.0) + \
                    e.self_device_time_total
        # busy time: the union of the kernels' intervals, since the
        # flash-decode merge is launched before the range kernel ends
        spans = [(e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = busy_us((a, b) for _, a, b in spans) / 1e3
        attn_ms = busy_us((a, b) for n, a, b in spans
                          if "attention_" in n) / 1e3
        top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:6]
        print(json.dumps({"phase": "model_profile", "engine": engine,
                          "profiled_step_ms": profiled_ms,
                          "device_ms": device_ms,
                          "top_kernels_ms": [[n[:90], t / 1e3]
                                             for n, t in top]}), flush=True)
        measured = device_ms > 0
        line = {
            "phase": "model", "model": cfg.name, "engine": engine,
            "layers": cfg.n_layers, "batch": MODEL_BATCH,
            "prompt_len": PROMPT_LEN, "max_gen": MAX_GEN,
            "init_s": init_s, "weights_gb": mem_gb,
            "prefill_ms": prefill_ms, "per_step_ms": per_step_ms,
            "untraced_per_step_ms": untraced_step_ms,
            "step_bytes": step_bytes, "step_bound_ms": step_bound_ms,
            "step_bound_share": step_bound_ms / per_step_ms,
            "device_busy_share": (device_ms / profiled_ms if measured
                                  else "not measured"),
            "attention_ms_per_step": attn_ms if measured else "not measured",
            "attention_share_of_step": (attn_ms / per_step_ms if measured
                                        else "not measured"),
            "flash_decode_launches": launches[f"attention_{engine}"],
            "decode_step_max_abs_err_vs_dense": step_err,
            "card": card,
        }
        print(json.dumps(line), flush=True)
        del ex, eng, dense, batch, logits, caches, twin, got, want, tok, prof
        del log
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    agree = (tokens["vector"] == tokens["matrix"]).float().mean().item()
    print(f"model: greedy tokens agree between the vector and matrix "
          f"flash-decode engines on {agree:.1%} of {tokens['vector'].numel()} "
          f"positions", flush=True)
    path = write_serving_json(kernel, records, str(ROOT / "build" /
                                                   "runs_torch"),
                              env=bench_env("cuda", DEFAULT_DISPATCHER.hw.name))
    try:
        results = check_records([load_file(path)])
    except (OSError, ValueError, NotImplementedError) as exc:
        failures.append(f"model records: {exc}")
        return launches
    by_claim = {}
    for r in results:
        c = by_claim.setdefault(r.claim, {"checked": 0, "violations": 0})
        c["checked"] += 1
        c["violations"] += int(not r.passed)
        if r.claim in ("model_verdict", "trace_reconciliation"):
            print(json.dumps({"claim": r.claim, "engine": r.record.engine,
                              "passed": r.passed, "detail": r.detail}),
                  flush=True)
    print(json.dumps({"model_claims": by_claim}), flush=True)
    for r in violations(results):
        failures.append(f"model claim {r.claim} violated by "
                        f"{r.record.kernel}/{r.record.engine}: {r.detail}")
    return launches


def _launch_check(tag, launches, names, failures):
    """Fail for each (family, engine) kernel of a path that never ran."""
    for name in names:
        for engine in ("vector", "matrix"):
            if launches.get(f"{name}_{engine}", 0) == 0:
                failures.append(f"{tag}: {name}_{engine} never launched")


def _tune_phase(torch, hw, card, failures):
    """Tile search on the card for every tunable family, both engines, at
    the STREAM points (phase 4's inputs).  Returns the cache written to
    build/runs_torch/tuned.json and the phase's launches per kernel."""
    import numpy as np

    from repro_torch.bench.bench_kernels import stream_points
    from repro_torch.core.timing import time_fn
    from repro_torch.kernels import _ext, registry
    from repro_torch.tuning import TuningCache, env_fingerprint, tune_op

    path = ROOT / "build" / "runs_torch" / "tuned.json"
    cache = TuningCache(fingerprint=env_fingerprint())
    t_phase = time.perf_counter()
    searches = 0
    torch.cuda.synchronize()
    _ext.reset_launches()
    for name in TUNED:
        op = registry.get(name)
        for pt in stream_points(op, np.random.default_rng(SEED), "cuda"):
            label, _ = _point_label(name, pt)
            for engine in ("vector", "matrix"):
                timings, skipped = [], []

                def timer(fn, timings=timings):
                    t = time_fn(fn, warmup=WARMUP, iters=ITERS)
                    timings.append(t)
                    return t

                def note(msg, skipped=skipped):
                    if ": skipped (" in msg:
                        skipped.append(msg)
                try:
                    entry = tune_op(op, engine=engine, dtype=pt.dtype,
                                    size=pt.size, hw_model=hw.name,
                                    timer=timer, verbose=note,
                                    inputs=(pt.args, pt.kwargs))
                except RuntimeError as exc:
                    failures.append(f"tune/{label}/{engine}: {exc}")
                    continue
                searches += 1
                failures.extend(f"tune/{label}: {m}" for m in skipped)
                # a family's key holds one entry: the faster point's
                # winner (the 2-D stencil's over the 3-D one)
                cache.merge(TuningCache([entry]))
                print(json.dumps({
                    "phase": "tune", "point": label, "engine": engine,
                    "params": dict(entry.params),
                    "best_us": entry.best_us,
                    "default_us": entry.default_us,
                    "default_iqr_us": timings[0].iqr_us,
                    "default_minus_best_us":
                        entry.default_us - entry.best_us,
                    "candidates": len(timings), "card": card}),
                    flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    launches = dict(_ext.LAUNCHES)
    _launch_check("tune", launches, TUNED, failures)
    cache.save(str(path))
    back = TuningCache.load(str(path))
    sources = sorted({e.source for e in back})
    if sources != ["cuda"] or len(back) != len(cache):
        failures.append(f"tuned.json: {len(back)} entries of sources "
                        f"{sources}, expected {len(cache)} of ['cuda']")
    print(json.dumps({"tune": {"searches": searches, "entries": len(back),
                               "path": "build/runs_torch/tuned.json",
                               "phase_s": time.perf_counter() - t_phase,
                               "card": card}}), flush=True)
    return back, launches


def _tuned_sweep_phase(torch, hw, card, failures, cache):
    """The STREAM sweep with the tuned tiles, into build/runs_torch_tuned;
    each point's tuned median beside phase 6's untuned one.  Returns the
    phase's launches per kernel."""
    from repro_torch.bench import bench_kernels
    from repro_torch.bench.common import bench_env, write_json
    from repro_torch.kernels import _ext, registry
    from repro_torch.report import check_records, load_dir, violations

    out_dir = ROOT / "build" / "runs_torch_tuned"
    shutil.rmtree(out_dir, ignore_errors=True)
    untuned = {}
    for rs in load_dir(str(ROOT / "build" / "runs_torch")):
        if rs.kind == "bench":
            for rec in rs.records:
                untuned[(rec.kernel, rec.engine, rec.size, rec.dtype)] = rec
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    _ext.reset_launches()
    for op in registry.all_ops():
        recs = bench_kernels.records_for(op, hw=hw, device="cuda",
                                         stream=True, tuned=cache)
        write_json(op.name, recs, str(out_dir),
                   env=bench_env("cuda", hw.name))
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    _launch_check("tuned sweep", launches,
                  [op.name for op in registry.all_ops()], failures)
    try:
        sets = load_dir(str(out_dir))
        results = check_records(sets)
    except (OSError, ValueError, NotImplementedError) as exc:
        failures.append(f"tuned records: {exc}")
        return launches
    for r in violations(results):
        failures.append(f"tuned sweep: claim {r.claim} violated by "
                        f"{r.record.kernel}/{r.record.engine}/"
                        f"{r.record.dtype}: {r.detail}")
    slower = 0
    for rs in sets:
        for rec in rs.records:
            if rec.kernel in TUNED and not rec.tile_config:
                failures.append(f"tuned sweep: {rec.kernel}/{rec.engine}/"
                                f"{rec.dtype} has no tile_config")
            base = untuned.get((rec.kernel, rec.engine, rec.size, rec.dtype))
            gap = (rec.us_per_call - base.us_per_call
                   if base is not None else None)
            beyond = bool(gap is not None and gap > base.iqr_us)
            slower += int(beyond)
            print(json.dumps({
                "phase": "tuned_sweep", "kernel": rec.kernel,
                "engine": rec.engine, "size": rec.size, "dtype": rec.dtype,
                "tile": dict(rec.tile_params or {}),
                "tuned_us": rec.us_per_call, "tuned_iqr_us": rec.iqr_us,
                "untuned_us": base.us_per_call if base else None,
                "untuned_iqr_us": base.iqr_us if base else None,
                "slower_beyond_untuned_iqr": beyond, "card": card}),
                flush=True)
    print(json.dumps({"tuned_sweep": {
        "records": sum(len(rs.records) for rs in sets),
        "claims": len(results), "violations": len(violations(results)),
        "slower_beyond_iqr": slower, "dir": "build/runs_torch_tuned",
        "phase_s": time.perf_counter() - t_phase, "card": card}}),
        flush=True)
    return launches


def _online_phase(torch, card, failures):
    """SCALE / Triad / AXPY served at phase 7's traffic by the online tile
    bandit, warm-started from tuned.json; the records verified (the
    online_ceiling replay included) and the winners persisted.  Returns
    the phase's launches per kernel."""
    import numpy as np

    from repro_torch.bench.common import bench_env, write_serving_json
    from repro_torch.bench.serve import _persist_online
    from repro_torch.core.dispatch import DEFAULT_DISPATCHER
    from repro_torch.kernels import _ext, registry
    from repro_torch.report import check_records, load_file, violations
    from repro_torch.serving import (BatchPolicy, OnlineKernelBatchExecutor,
                                     SessionConfig, run_session)
    from repro_torch.tuning import OnlineTuner

    out_dir = str(ROOT / "build" / "runs_torch")
    env = bench_env("cuda", DEFAULT_DISPATCHER.hw.name)
    policy = BatchPolicy(max_batch=SERVE_MAX_BATCH,
                         max_wait_s=SERVE_MAX_WAIT_S)
    launches, entries, t_phase = {}, [], time.perf_counter()
    DEFAULT_DISPATCHER.load_tuned(str(ROOT / "build" / "runs_torch" /
                                      "tuned.json"))
    try:
        for name in PACKED:
            op = registry.get(name)
            args, kw = op.make_inputs(np.random.default_rng(SEED),
                                      SERVE_ELEMENTWISE, "float32", "cuda")
            tuner = OnlineTuner(ONLINE_BUDGET,
                                cache=DEFAULT_DISPATCHER.tuning.cache,
                                hw_model=DEFAULT_DISPATCHER.hw.name)
            ex = OnlineKernelBatchExecutor("auto", max_batch=SERVE_MAX_BATCH,
                                           seed=SEED, tuner=tuner)
            ex.use_inputs(name, SERVE_ELEMENTWISE, "float32", args, kw)
            cfg = SessionConfig(kernel=name, workload="poisson",
                                engine="auto", rate_rps=SERVE_ELEMENTWISE_RPS,
                                duration_s=SERVE_DURATION_S,
                                size=SERVE_ELEMENTWISE, seed=SEED,
                                policy=policy, online_tune=True,
                                tune_budget=ONLINE_BUDGET)
            torch.cuda.synchronize()
            _ext.reset_launches()
            t0 = time.perf_counter()
            log, summary, record = run_session(cfg, executor=ex)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = dict(_ext.LAUNCHES)
            for engine in ("vector", "matrix"):
                launches[f"{name}_{engine}"] = counts.get(f"{name}_{engine}",
                                                          0)
            t = record["tuning"]
            (key,) = t["keys"]
            kd = t["keys"][key]
            pulled = {e["arm"] for e in kd["events"]}
            # one launch per batch, and one untimed warm-up per arm
            want = len(log.batches) + len(pulled)
            tag = f"online/{name}"
            if launches[f"{name}_vector"] != want or \
                    launches[f"{name}_matrix"]:
                failures.append(f"{tag}: {launches[f'{name}_vector']} vector "
                                f"and {launches[f'{name}_matrix']} matrix "
                                f"launches, expected {want} and 0")
            if t["decisions"] != len(log.batches) or \
                    log.completed != log.offered or \
                    record["engine"] != "vector":
                failures.append(f"{tag}: {t['decisions']} decisions for "
                                f"{len(log.batches)} batches, "
                                f"{log.completed}/{log.offered} served, "
                                f"engine {record['engine']}")
            winner = kd["arms"][kd["winner"]]
            print(json.dumps({
                "phase": "online_serving", "kernel": name,
                "engine": record["engine"], "key": key,
                "warm_source": kd["warm_source"], "warm_arm": kd["arms"][0],
                "arms": len(kd["arms"]), "arms_pulled": len(pulled),
                "decisions": t["decisions"],
                "regret_us_total": t["regret_us_total"],
                "warm_us": kd["warm_us"], "best_us": kd["best_us"],
                "committed_us": kd["committed_us"], "winner": winner,
                "p50_ms": summary.p50_ms, "p99_ms": summary.p99_ms,
                "compute_p50_ms": summary.compute_p50_ms,
                "compute_p99_ms": summary.compute_p99_ms,
                "goodput_rps": summary.goodput_rps, "launches": want,
                "wall_s": wall_s, "card": card}), flush=True)
            path = write_serving_json(name, [record], out_dir, env=env,
                                      suffix="_online")
            entries.extend(tuner.to_entries())
            del ex, log, args, kw
            try:
                results = check_records([load_file(path)])
            except (OSError, ValueError, NotImplementedError) as exc:
                failures.append(f"{tag} records: {exc}")
                continue
            for r in results:
                if r.claim == "online_ceiling":
                    print(json.dumps({"claim": r.claim, "kernel": name,
                                      "passed": r.passed,
                                      "detail": r.detail}), flush=True)
            if "online_ceiling" not in {r.claim for r in results}:
                failures.append(f"{tag}: no online_ceiling claim checked")
            for r in violations(results):
                failures.append(f"{tag}: claim {r.claim} violated: "
                                f"{r.detail}")
        persisted = _persist_online(out_dir, entries)
    finally:
        DEFAULT_DISPATCHER.set_tuning_cache(None)
    print(json.dumps({"online_serving": {
        "sessions": len(PACKED), "persisted":
            str(pathlib.Path(persisted).relative_to(ROOT)),
        "online_entries": len(entries),
        "phase_s": time.perf_counter() - t_phase, "card": card}}),
        flush=True)
    return launches


def _ceiling_violations(report):
    """The summed Eq. 23/24 column of REPORT.md's claim table."""
    table = report.split("## Claim verification")[1].split("\n\n")[2]
    return sum(int(line.split(" | ")[2].split()[0])
               for line in table.splitlines()[2:])


def _report_phase(card, failures):
    """REPORT.md and the per-kernel pages of build/runs_torch, rendered
    twice into build/runs_torch: the two renders must be byte-identical
    and the ceiling column must read 0."""
    from repro_torch.report import write_report

    runs = ROOT / "build" / "runs_torch"
    where = {"runs_dir": str(runs), "report_path": str(runs / "REPORT.md"),
             "docs_dir": str(runs / "docs" / "benchmarks")}
    t0 = time.perf_counter()
    try:
        first = write_report(**where)
        texts = [pathlib.Path(p).read_text() for p in first]
        second = write_report(**where)
    except (OSError, ValueError, NotImplementedError) as exc:
        failures.append(f"report: {exc}")
        return
    identical = first == second and \
        texts == [pathlib.Path(p).read_text() for p in second]
    ceiling = _ceiling_violations(texts[0])
    if not identical:
        failures.append("report: two renders of build/runs_torch differ")
    if ceiling:
        failures.append(f"report: {ceiling} ceiling violations")
    print(json.dumps({"report": {
        "pages": [str(pathlib.Path(p).relative_to(ROOT)) for p in first],
        "ceiling_violations": ceiling, "identical": identical,
        "bytes": sum(len(t.encode()) for t in texts),
        "phase_s": time.perf_counter() - t0, "card": card}}), flush=True)


def _point_label(name, pt):
    """Phase 4's label and shape of one STREAM point."""
    if name in ("scale", "triad", "axpy"):
        return f"{name}/{pt.dtype}", (pt.size,)
    if name == "spmv":
        m, n = pt.args[0].shape
        return f"spmv/{m}x{n}", (m, n)
    if name == "stencil":
        u, spec = pt.args
        side = "^".join((str(u.shape[0]), str(u.ndim)))
        return f"stencil/{spec.name}/{side}", tuple(u.shape)
    q, k, _, _ = pt.args
    return (f"attention/{pt.dtype}/B{q.shape[0]}xS{k.shape[1]}",
            tuple(k.shape))


def _records_phase(torch, hw, card, failures):
    """The paper's steps 4-5 through the port's sweep and claims layer.

    Every family at the reference's bench_sizes and at the STREAM points,
    on the card with the card's HardwareSpec; the records written to
    build/runs_torch, loaded back and verified.  Returns the sweep's
    launches per kernel.
    """
    import numpy as np

    from repro_torch.bench import bench_kernels
    from repro_torch.bench.common import bench_env, write_json
    from repro_torch.kernels import _ext, registry
    from repro_torch.report import check_records, load_dir, violations

    out_dir = ROOT / "build" / "runs_torch"
    # records of an earlier run must not be verified in this one
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    _ext.reset_launches()
    n_records = 0
    for op in registry.all_ops():
        recs = bench_kernels.records_for(op, hw=hw, device="cuda")
        recs += bench_kernels.records_for(op, hw=hw, device="cuda",
                                          stream=True)
        write_json(op.name, recs, str(out_dir),
                   env=bench_env("cuda", hw.name))
        n_records += len(recs)
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    sweep_s = time.perf_counter() - t0
    for op in registry.all_ops():
        for engine in ("vector", "matrix"):
            if launches.get(f"{op.name}_{engine}", 0) == 0:
                failures.append(f"{op.name}_{engine}: no launch in the sweep")
    try:
        sets = load_dir(str(out_dir))
        results = check_records(sets)
    except (OSError, ValueError, NotImplementedError) as exc:
        failures.append(f"records: {exc}")
        return launches
    by_claim = {}
    for r in results:
        c = by_claim.setdefault(r.claim, {"checked": 0, "violations": 0})
        c["checked"] += 1
        c["violations"] += int(not r.passed)
    bad = violations(results)
    print(json.dumps({"claims": {"checked": len(results),
                                 "violations": len(bad),
                                 "by_claim": by_claim}}), flush=True)
    for r in bad:
        rec = r.record
        print(json.dumps({"violation": r.claim, "kernel": rec.kernel,
                          "engine": rec.engine, "size": rec.size,
                          "dtype": rec.dtype, "detail": r.detail}),
              flush=True)
        failures.append(f"claim {r.claim} violated by {rec.kernel}/"
                        f"{rec.engine}/{rec.size}/{rec.dtype}: {r.detail}")
    # per family and engine: records, claims, and the STREAM points'
    # engine medians beside their share of the byte bound
    summary = {}
    for rs in sets:
        for rec in rs.records:
            key = f"{rec.kernel}/{rec.engine}"
            s = summary.setdefault(key, {"records": 0, "l2_resident": 0,
                                         "claims": 0, "violations": 0,
                                         "stream": []})
            s["records"] += 1
            s["l2_resident"] += int(bool(rec.l2_resident))
            if not rec.l2_resident:
                s["stream"].append({
                    "size": rec.size, "dtype": rec.dtype,
                    "us_per_call": rec.us_per_call, "iqr_us": rec.iqr_us,
                    "profiler_device_us": rec.profiler_device_us,
                    "ref_us_per_call": rec.ref_us_per_call,
                    "bound_share": rec.bound_share(hw.mem_bw),
                    "pct_of_bound_traits":
                        dict(rec.trace or {}).get("roofline", {}).get(
                            "pct_of_bound"),
                    "max_err": rec.max_err})
    for r in results:
        s = summary[f"{r.record.kernel}/{r.record.engine}"]
        s["claims"] += 1
        s["violations"] += int(not r.passed)
    print(json.dumps({"records": n_records, "dir": "build/runs_torch",
                      "hw_model": hw.name, "sweep_s": sweep_s,
                      "by_kernel": summary, "card": card}), flush=True)

    # the tracer's cost on one elementwise STREAM point
    op = registry.get("scale")
    pt = next(bench_kernels.stream_points(op, np.random.default_rng(SEED),
                                          "cuda"))
    overhead = bench_kernels.tracer_overhead(op, pt.args, pt.kwargs,
                                             "vector")
    print(json.dumps({"trace_overhead": dict(
        overhead, point=f"scale/vector/{pt.dtype}/n={pt.size}", card=card)}),
        flush=True)
    return launches


def _dmma_floor_ms(args, kw, hw):
    """Least time of the banded formulation on the FP64 tensor cores: per
    step and axis pass, ceil((8 + 2r) / 4) DMMA m8n8k4 for each 8 x 8 tile
    of outputs, at the datasheet's FP64 tensor-core rate (ms)."""
    u, spec = args
    per_tile = -(-(8 + 2 * spec.radius) // 4)
    dmmas = kw["steps"] * spec.ndim * per_tile * u.numel() / 64
    return dmmas * DMMA_FLOPS / hw.matrix.peak_flops * 1e3


def _csr_bytes(bell, x):
    """Bytes of y = A x with A in CSR: the float32 values and int32 column
    ids of the nonzeros, the m + 1 row pointers, x and y."""
    m, n = bell.shape
    nnz = int((bell.blocks != 0).sum())
    return nnz * 8 + (m + 1) * 4 + n * x.element_size() + m * 4


def _host_and_device_us(torch, fn, calls=50):
    """Host enqueue time per call (no synchronisation inside the window),
    and the device time per call from torch.profiler (the union of the
    intervals in which the call's kernels run)."""
    from repro_torch.core.timing import device_busy_us
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    device_us = device_busy_us(fn, calls=calls)
    return host_us, (device_us if device_us > 0 else "not measured")


def _library_ms(torch, F, name, args, kw, time_fn):
    """One PyTorch call computing the same function, timed (ms): a
    yardstick only, which the port never calls."""
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
        # torch.sparse_bsr_tensor is not used: its matvec refuses the
        # 8x128 blocks.  A CSR tensor of the same matrix (built here,
        # outside the timed call) goes to cuSPARSE's SpMV.
        csr = bell.todense().to_sparse_csr()
        fn = (torch.mv, csr, x)
    elif name == "attention":
        q, k, v, kv_len = args
        b, kh, g, dh = q.shape
        # SDPA's layout, and only the kv_len valid positions (7/8 of the
        # cache), arranged outside the timed call
        qs = q.reshape(b, kh * g, 1, dh)
        ks = k[:, :kv_len].permute(0, 2, 1, 3).contiguous()
        vs = v[:, :kv_len].permute(0, 2, 1, 3).contiguous()
        major, minor = (int(x) for x in torch.__version__.split(".")[:2])
        if (major, minor) >= (2, 5):
            fn = (lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                         enable_gqa=True),)
        else:
            ks = ks.repeat_interleave(g, dim=1)
            vs = vs.repeat_interleave(g, dim=1)
            fn = (F.scaled_dot_product_attention, qs, ks, vs)
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
