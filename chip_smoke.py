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
serving: Mistral-NeMo-12B and StableLM-2-12B (head dim 160) at full
width and depth (random float32 weights from a seed) serve seeded
traffic through the same scheduler, every layer's decode attention
through the flash-decode kernel; then the
MoE family, DeepSeek-V2-Lite-16B (MLA, 64 + 2 experts) at full width and
depth and Qwen3-MoE-235B-A22B (128 experts, flash-decode at 16 query
heads per KV head) at full width, 6 of its 94 layers; then the SSM and
hybrid families, Mamba2-780m and Zamba2-7B (its shared attention block
through flash-decode at head dim 112) at full width and depth; then the
multimodal-frontend families, SeamlessM4T-large-v2 (an audio encoder and
cross-attention on cached encoder K / V; flash-decode at head dim 64) at
full width and depth and Qwen2-VL-72B (1024 vision patch positions,
M-RoPE) at full width, 16 of its 80 layers; then Mistral-NeMo-12B
decoding from an int8 KV cache, dequantized into the flash-decode kernel.
Training: Mistral-NeMo-12B at full width on 8 of its 40 layers takes
AdamW steps with remat, a crashed run resumes bit for bit, and the
training launcher runs as a user runs it.  Tile
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
     past kv_len, each also bit for bit against reading every position, at
     G = 4 and 1 (head tile 8) and G = 16 and 12 (head tile 16), at Dh 128
     and at the configs' Dh 112 (Zamba2-7B) and 160 (StableLM-2-12B);
     before them, flash-decode's ptxas registers and spills per kernel;
  4. the experiment at STREAM size (every array >= 4x the 50 MiB L2):
     launch counts reset before it and read after it, one JSON line per
     point and engine, with the host's enqueue time and torch.profiler's
     device time per call, then each output held against its plain
     version (the stencils and the elementwise kernels bit for bit);
     flash-decode at Mistral-NeMo's decode shape (G = 4), at Qwen3-MoE's
     (B 4, KH 4, G 16, Dh 128, S 32768, kv_len 28672) and at
     StableLM-2-12B's (B 4, KH 8, G 4, Dh 160);
  5. library yardsticks (one PyTorch call computing the same function;
     one line per flash-decode point with SDPA's CUDA-event time, device
     time and host enqueue time), and SpMV's byte bound in CSR;
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
     written and verified, the model verdict at full width included; then
     StableLM-2-12B at full width and depth (flash-decode at Dh 160), both
     sessions on one set of weights, BENCH_serve_lm-stablelm-12b.json;
 8b. the MoE family the same way: DeepSeek-V2-Lite-16B at full width
     and depth (~63 GB), one session (MLA decodes in latent space: 0
     flash-decode launches, the engine flag does not apply), the served
     engine's decode step (absorbed MLA, decode MoE) on the caches of a
     prefill with the MoE capacity lifted, held against forward over the
     prompt plus that token, capacity lifted too; Qwen3-MoE-235B-A22B at
     full width cut to 6 of 94 layers (64.7 GB), one session per
     flash-decode engine on one set of weights, (batches + 1) x 6 x 15
     launches each, its step held against the dense-attention path.  Per
     session: weights_gb, init_s, prefill and per-step times (traced and
     untraced), the step beside the traits bound (the experts a step
     touches) and the all-weights bound, the device-busy share and top
     kernels of one profiled step, the MoE FFNs' device time per step;
     BENCH_serve_lm-<model>.json written and verified;
 8c. the SSM and hybrid families the same way, at a prompt of 512 (4
     chunks of 128; the chunked scan takes only multiples of its chunk):
     Mamba2-780m at full width and depth (~3.4 GB), one session (0
     flash-decode launches: an SSM decodes from its recurrent state), its
     chunked prefill and 128 teacher-forced recurrent steps each held
     against forward over the 640 tokens at the step's position;
     Zamba2-7B at full width and depth (~27 GB), one session per
     flash-decode engine on one set of weights, (batches + 1) x 13 x 15
     launches each (its shared attention block after each of 13
     super-blocks: flash-decode at G 1, Dh 112), its step held against
     the dense-attention path;
 8d. the multimodal-frontend families the same way: SeamlessM4T-large-v2
     at full width and depth (~8.1 GB; 24 encoder layers over the prompt's
     496 audio frames, 24 decoder layers with cross-attention on the
     cached encoder K / V), one session per flash-decode engine on one set
     of weights, (batches + 1) x 24 x 15 launches each (flash-decode at
     G 1, Dh 64), its step held against the dense-attention path and its
     prefill and 4 teacher-forced steps against forward over the prompt
     plus those tokens (the same frames); Qwen2-VL-72B at full width cut
     to 16 of 80 layers (~66 GB), a prompt of 1024 patch positions and
     496 of text, one session per engine on one set of weights, (batches
     + 1) x 16 x 15 launches each (G 8, Dh 128, cache 1536), its step held
     against the dense-attention path; then K4 at both decode shapes as
     in 8c, each S's kv_len edges bit for bit against the full read;
 8e. the int8 KV cache: Mistral-NeMo-12B at full width and depth, the
     model phase's prompts prefilled into float caches, quantized into an
     int8 cache of 512 by the step's own _int8_cache_update, then per
     flash-decode engine 16 decode steps on it through the kernel, each
     held against the dense-attention path on the same int8 cache, 40 x
     16 launches of the engine's kernel and none of the other; the logit
     gap and greedy agreement against the float32 cache printed; one
     layer's cache read at S 32768, kv_len 28672 from a float32 and from an
     int8 cache (device time beside the bytes each moves);
 8f. the expert share's grouped SwiGLU (csrc/experts.cu) at DeepSeek-V2's
     widths (20 held experts, d 5120, f 1536, float32): a decode step's
     routing (Poisson rows, 2.4 an expert), 3 rows each, one expert over
     a pass of 8 rows, all 64 rows on one expert; each one launch, held
     against grouped_swiglu_plain (1e-5 + 1e-5 |b|), timed beside its
     bound and its plain version;
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
 11b. the sharded sweep: bench_kernels.records_for at every family's
     STREAM points, both engines and both dtypes, split 4 ways
     (repro_torch.sharding, one shard after another on the card; K4 at
     Mistral-NeMo's KH 8, 2 heads a shard, and at Qwen3-MoE's G 16, KH 4,
     1 head a shard), launch counts reset before and read after; every
     combined output bit for bit against the unsharded kernel's on the
     card, and again at 3 shards, untimed (uneven ranges, the stencils'
     clipped halos); build/runs_torch/BENCH_<kernel>_mesh4.json written
     and verified (the shard claims included, 0 violations); one line per
     point with parallel / serial time, each shard's wall beside its time
     on the card (20 queued calls between one CUDA-event pair), and the
     unsharded kernel's time from phase 6;
 11c. elastic serving: ElasticSession under ChaosInjector.seeded(0, 0.5,
     max_width=4) at 2 shards for SCALE at phase 7's traffic and for 2d5pt
     and float32 flash-decode at 200 req/s; every re-dispatch exact, every
     resize reshard_exact, availability >= 0.99, elastic_integrity passing
     (BENCH_serve_<kernel>_mesh2.json); checkpoint_session mid-session and
     ElasticSession.restore landing on the uninterrupted run's checksum;
     then python -m repro_torch.bench serve --mesh 4 and --online-tune
     --slo-route (an overload: router widths above 1) into
     build/runs_torch_serve/, verified and gated;
 11d. the measured mesh: one rank group of 4 (gloo processes, every one
     on this card, halos through pinned host memory); each family's first
     STREAM point (float32) through MeshExecutor at 4 ranks, with the
     engine the dispatcher picks, its output bit for bit against the
     unsharded kernel's, measured (mesh wall, exchange alone, the virtual
     slowest shard, skew) into phase 11b's records of the point
     (build/runs_torch_mesh/BENCH_<kernel>_mesh4.json, schema 6, the
     overlap probe in the env), which pass collective_cost and mesh_skew
     with 0 violations, the gate and the report's measured-collectives
     section; the 2d5pt point at 3 ranks (an uneven, padded edge) bit for
     bit; serve --mesh 4 --real on SCALE at phase 7's traffic;
     launch.train --mesh 2x2 --devices 4 on reduced Mistral-NeMo-12B
     against --mesh 1x1 (loss rtol 1e-5, parameters 5e-4), and the 2x2
     checkpoint restored onto 1 x 2 ranks (reshard_restore) bit for bit;
 12. repro_torch.bench.compare with build/runs_torch as both baseline and
     candidate, which must pass (the regret gate joins the online pairs);
 13. repro_torch.report.write_report on build/runs_torch into
     build/runs_torch/REPORT.md and build/runs_torch/docs/benchmarks/,
     twice, byte-identical, the ceiling column at 0 violations;
 14. training: Mistral-NeMo-12B at full width on 8 of 40 layers, 8 x
     128 tokens a step from TokenPipeline, float32 (TF32 off), remat,
     AdamW on a cosine schedule, 6 steps: step 0's loss against forward's
     masked NLL (1e-5), its gradients with and without remat, step 1's
     AdamW update of two leaves against the CPU's (1e-6 + 1e-5 |b|), every
     loss finite, batch 0's loss lower after the 6 steps, an int8
     gradient-compressed step against the CPU's quantization bit for
     bit; step time, device time, peak memory, tokens/s, 6 N D over the
     float32 peak; the restart drill at reduced DeepSeek-7B under
     deterministic algorithms, bit for bit; python -m
     repro_torch.launch.train as a subprocess;
 15. the examples and the dry run: examples_torch/'s quickstart,
     kernel_showdown (K1-K3 on both engines against their oracles, every
     max_err under 1e-4), serve_lm on each flash-decode engine (K4) and
     train_lm (the tiny preset, a crash at step 4 and the resume from
     step 3's checkpoint) through their main(argv) on the card, every
     kernel of K1-K4 launched on both engines; then the dry run in a
     subprocess on the CPU (meta tensors over a fake 16 x 16 mesh, H100
     terms; after the card's phases, so it perturbs none of their host
     times):
     Mistral-NeMo-12B's train_4k, prefill_32k and decode_32k and
     DeepSeek-V2-Lite-16B's decode_32k at full size, each row ok, then
     launch.report's three sections of build/runs_torch_dryrun/dryrun.json;
 16. one JSON line of per-kernel numbers, then the result line.

Exits non-zero, printing no result, without a card or without the
repository's sources beside this file.
"""
from __future__ import annotations

import dataclasses
import gc
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

#: Phase 3's (G, Dh) at the kv_len edges: the head tiles of 8 (G 4, 1) and
#: 16 (G 16, 12 and its smallest group 9) at Dh 128, and the configs' other
#: head dims, each at both head tiles.
EDGE_GROUPS = ((4, 128), (16, 128), (12, 128), (9, 128), (1, 112),
               (4, 112), (16, 112), (4, 160), (16, 160))

#: Float32 tolerance of the model phase's decode step against the plain
#: dense-attention path: the reference's own model tier
#: (tests/test_model_engine.py), elementwise |a - b| <= atol + rtol |b|.
STEP_RTOL, STEP_ATOL = 1e-3, 1e-4

#: Phase 15's dry-run rows: (architecture, cell) at 16 x 16, full size.
DRYRUN_ROWS = (("mistral-nemo-12b", "train_4k"),
               ("mistral-nemo-12b", "prefill_32k"),
               ("mistral-nemo-12b", "decode_32k"),
               ("deepseek-v2-lite-16b", "decode_32k"),
               ("qwen1.5-32b", "decode_32k"))
#: Its own directory, apart from the BENCH records of build/runs_torch.
DRYRUN_OUT = ROOT / "build" / "runs_torch_dryrun" / "dryrun.json"

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
#: The LM decode phase: Mistral-NeMo-12B, full width and depth, float32;
#: then StableLM-2-12B the same way (flash-decode at head dim 160).
MODEL = "mistral-nemo-12b"
MODEL_DH160 = "stablelm-12b"
MODEL_BATCH, PROMPT_LEN, MAX_GEN = 4, 496, 16
#: Phase 8c: Mamba2-780m and Zamba2-7B at full width and depth.  Their
#: prompt is 4 chunks of 128: the chunked SSD scan takes only multiples of
#: its chunk (the reference asserts it), and 496 is none.  Mamba2's
#: recurrence is held against forward over the prompt and this many
#: teacher-forced tokens.
SSM_MODEL, HYBRID_MODEL = "mamba2-780m", "zamba2-7b"
SSM_PROMPT_LEN, RECURRENT_STEPS = 512, 128
#: Its traffic: the reference's ``serve --workload lm`` defaults.
LM_RPS, LM_DURATION_S, LM_SLO_MS = 8.0, 1.0, 30000.0
#: Phase 8b: Qwen3-MoE-235B-A22B's layers on one card (6 of 94: 64.7 GB
#: of float32 weights with the embedding and head).
MOE_QWEN_LAYERS = 6
#: Phase 8d: SeamlessM4T-large-v2 at full width and depth, its prefill and
#: this many teacher-forced steps also held against forward; Qwen2-VL-72B
#: at full width on VISION_LAYERS of its 80 layers, the most that fit
#: (3.51 GB of float32 weights each, 9.97 GB embedding and head: 66.2 GB;
#: the prefill's and checks' working set took 9.1 GB more at 12 layers on
#: an H100 80GB HBM3),
#: its prompt 1024 patch positions and 496 of text, so that the served
#: cache of 1536 keeps flash-decode's block_s at 512.
ENCDEC_MODEL, VISION_MODEL = "seamless-m4t-large-v2", "qwen2-vl-72b"
TEACHER_STEPS = 4
VISION_LAYERS, VISION_PROMPT_LEN = 16, 1520
#: Phase 14: Mistral-NeMo-12B trained at full width on TRAIN_LAYERS of its
#: 40 layers (3.52 B float32 parameters: 56 GB with their gradients and
#: AdamW's two moments), at the reference launcher's batch and sequence.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 8, 128, 6
#: The families with a tile space, tuned on both engines in phase 9.
TUNED = ("scale", "triad", "axpy", "stencil", "attention")
#: The online bandit's exploration pulls per key (the reference's default).
ONLINE_BUDGET = 8
#: Phase 11b: the STREAM points split this many ways, then checked
#: untimed at SHARD_UNEVEN shards (uneven ranges, clipped halos).
SHARD_MESH, SHARD_UNEVEN = 4, 3
#: Phase 11c: elastic sessions start at ELASTIC_WIDTH shards and may grow
#: to ELASTIC_MAX; the checkpoint drill stops after this many batches.
ELASTIC_WIDTH, ELASTIC_MAX, ELASTIC_STOP = 2, 4, 100
#: Phase 11c's per-request sessions: 2d5pt at its STREAM side and
#: flash-decode at a cache of this length (make_inputs' KH 2 shape).
ELASTIC_STENCIL, ELASTIC_ATTENTION = 8192, 32768
#: Phase 11c's SLO-routed session: an overload of small requests, so the
#: queue outgrows the router's grow depth while headroom is thin.
ROUTE_SIZE, ROUTE_RPS, ROUTE_DURATION_S = 2**20, 200000.0, 0.05
#: Phase 11d: the measured mesh on MESH_RANKS ranks (one group started
#: once), the 2d5pt stencil also at MESH_UNEVEN; each measured step's
#: median over MESH_ITERS after 2 warm-ups; the trainer's data x model
#: mesh against 1 x 1 on a reduced config, then the restore onto 1 x 2.
MESH_RANKS, MESH_UNEVEN, MESH_ITERS = 4, 3, 10
MESH_TRAIN_ARCH, MESH_TRAIN_STEPS = "mistral-nemo-12b", 4


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
        # stencil_kernel<ndim, radius, box, matrix>; attention's float32
        # ring kernels attention_{vector,matrix}_ring_kernel<DH>
        match = re.search(r"(elementwise|spmv|stencil|attention|experts)_"
                          r"(?:(vector|matrix|gate_up|down)_)?(?:ring_)?"
                          r"kernel"
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
    if len(sass) != 9:
        failures.append(f"SASS audit found {sorted(sass)}, expected the "
                        f"nine family/engine kernels (experts: vector "
                        f"only)")
    # flash-decode's registers and spills per instantiation (ptxas -v of
    # the build): dtype/head dim/head tile/engine -> [registers, spill
    # store bytes, spill load bytes]
    print(json.dumps({"ptxas_attention": {
        f"{u['dtype']}/{u['dh']}/{u['head_tile']}/{u['engine']}":
            [u.get("registers"), u.get("spill_store_bytes", 0),
             u.get("spill_load_bytes", 0)]
        for u in _ext.attention_kernel_usage()}}), flush=True)

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
                   (1, 256, 1, 1, 32), (2, 512, 2, 16, 128),
                   (1, 256, 1, 12, 64),
                   # the configs' other head dims: Zamba2-7B's 112 (G 1),
                   # StableLM-2-12B's 160 (G 4), both head tiles
                   (1, 512, 2, 1, 112), (1, 256, 1, 12, 112),
                   (2, 512, 2, 4, 160), (1, 256, 2, 16, 160))]
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
    # (2, 1024, 2, g, dh) cuts the cache into ranges of 64 positions. Each
    # kv_len >= 1 is also held bit for bit against the same kernel reading
    # every range and position (end = S), as the reference does.  G = 4
    # and 1 run the head tile of 8; G = 16 (Qwen3-MoE's group), 12 and 9
    # that of 16; at Dh 128 and at the configs' 112 (Zamba2-7B) and 160
    # (StableLM-2-12B)
    b, s, kh, block_s = 2, 1024, 2, 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for g, dh, kv_len in ((g, dh, kv) for g, dh in EDGE_GROUPS
                          for kv in (0, 1, 15, 16, 17, 63, 64, 65, s - 1,
                                     s)):
        qkv = [torch.randn(shape, generator=gen).cuda() for shape in
               ((b, kh, g, dh), (b, s, kh, dh), (b, s, kh, dh))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in qkv)
            for engine in ("vector", "matrix"):
                rows = _ext.attention_ranges(s, block_s, b * kh, sms, kv_len,
                                             dtype, g, engine, dh)[0]
                tag = (f"attention/{engine}/{dtype}/G={g}/Dh={dh}/kv_len="
                       f"{kv_len} of {s} in ranges of {rows}")
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
                if op.name == "attention" and engine == "vector":
                    # the CUDA cores' floor: one FFMA per multiply-add,
                    # 128 per SM and clock, beside the SM clock now
                    line.update(_ffma_floor(torch, work / 2, device_us))
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
    library, library_device = {}, {}
    for (op, point, dtype, shape, args, kw, *_rest) in results:
        fn = _library_fn(torch, F, op.name, args, kw)
        library[point] = time_fn(fn, warmup=WARMUP,
                                 iters=ITERS).median_us / 1e3
        if op.name == "attention":
            # SDPA's device time too: its event pair, like the kernels',
            # may bracket host time
            host_us, device_us = _host_and_device_us(torch, fn)
            library_device[point] = (device_us / 1e3 if device_us !=
                                     "not measured" else device_us)
            print(json.dumps({"point": point, "library": "SDPA on the "
                              "kv_len valid positions",
                              "library_ms": library[point],
                              "library_device_ms": library_device[point],
                              "library_host_enqueue_us": host_us,
                              "card": card}), flush=True)
        if op.name == "spmv":
            # the same matrix in CSR: the bytes a CSR SpMV must move
            bell, x = args
            csr_ms = _csr_bytes(bell, x) / hw.mem_bw * 1e3
            print(json.dumps({"point": point, "library_ms": library[point],
                              "csr_bound_ms": csr_ms, "card": card}),
                  flush=True)
    del points, results, args, kw, outs, times, want, traits, bell, x, xg
    del fn
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
    torch.cuda.empty_cache()

    # -- 8b. the MoE family: DeepSeek-V2-Lite-16B and Qwen3-MoE-235B-A22B ----
    model_launches.update(_moe_phase(torch, hw, card, failures))

    # -- 8c. the SSM and hybrid families: Mamba2-780m and Zamba2-7B --------
    model_launches.update(_ssm_phase(torch, hw, card, failures))

    # -- 8d. the frontend families: SeamlessM4T-large-v2 and Qwen2-VL-72B --
    model_launches.update(_frontend_phase(torch, hw, card, failures))

    # -- 8e. the int8 KV cache through flash-decode ------------------------
    model_launches.update(_int8_phase(torch, hw, card, failures))

    # -- 8f. the expert share's grouped SwiGLU -------------------------------
    _experts_phase(torch, hw, card, failures)

    # -- 9. tile tuning on the card ---------------------------------------
    cache, tune_launches = _tune_phase(torch, hw, card, failures)
    torch.cuda.empty_cache()

    # -- 10. the STREAM sweep with the tuned tiles -------------------------
    tuned_launches = _tuned_sweep_phase(torch, hw, card, failures, cache)
    torch.cuda.empty_cache()

    # -- 11. online-tuned kernel serving ------------------------------------
    online_launches = _online_phase(torch, card, failures)
    torch.cuda.empty_cache()

    # -- 11b. the sharded sweep ---------------------------------------------
    sharded_launches = _sharded_phase(torch, hw, card, failures)
    torch.cuda.empty_cache()

    # -- 11c. elastic serving -----------------------------------------------
    elastic_launches = _elastic_phase(torch, card, failures)
    torch.cuda.empty_cache()

    # -- 11d. the measured mesh ---------------------------------------------
    mesh_launches = _mesh_phase(torch, hw, card, failures)
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

    # -- 14. training ---------------------------------------------------------
    _train_phase(torch, hw, card, failures)

    # -- 15. the examples, then the dry run ----------------------------------
    example_launches = _examples_phase(torch, card, failures)
    torch.cuda.empty_cache()
    _dryrun_phase(card, failures)

    # -- 16. the per-kernel line ---------------------------------------------
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
            "sharded_launches": sharded_launches.get(r["name"], 0),
            "elastic_launches": elastic_launches.get(r["name"], 0),
            "mesh_launches": mesh_launches.get(r["name"], 0),
            "example_launches": example_launches.get(r["name"], 0),
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
            entry["library_device_ms"] = library_device[r["point"]]
        if r["name"] == "stencil_matrix":
            entry["dmma_floor_ms"] = r["dmma_floor_ms"]
        if r["op"] == "attention":
            # flash-decode's own main path is LM decode (phases 8-8e): its
            # launches summed over the models' sessions and the int8 steps
            per_model = {m: n.get(r["name"], 0)
                         for m, n in model_launches.items()}
            entry["experiment_launches"] = entry["launches"]
            entry["model_launches"] = per_model
            entry["launches"] = sum(per_model.values())
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


def _load_example(name):
    import importlib.util
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _examples_phase(torch, card, failures):
    """Phase 15, first half (module docstring): the four examples'
    ``main(argv)`` on the card.  Returns their launches per kernel."""
    from repro_torch.kernels import _ext
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    _ext.reset_launches()
    errs = {}
    out = {}
    try:
        for name in ("quickstart", "kernel_showdown"):
            errs.update({f"{name}:{k}": v for k, v in
                         _load_example(name).main([]).items()})
        serve = _load_example("serve_lm")
        for engine in ("vector", "matrix"):
            summary = serve.main(["--engine", engine, "--duration", "1"])
            out[f"serve_lm_{engine}"] = {
                k: getattr(summary, k)
                for k in ("offered", "completed", "p50_ms", "p99_ms")}
        train = _load_example("train_lm")
        ckpts = ROOT / "build" / "examples_train"
        shutil.rmtree(ckpts, ignore_errors=True)
        argv = ["--steps", "6", "--seq", "128", "--ckpt-every", "3",
                "--ckpt-dir", str(ckpts)]
        try:
            train.main(argv + ["--fail-at", "4"])
            crashed = False
        except RuntimeError as exc:
            if "injected failure" not in str(exc):
                raise
            crashed = True
        _, _, metrics = train.main(argv)
        loss = float(metrics["loss"])
        out["train_lm"] = {"crashed_at_4": crashed, "final_loss": loss}
        if not (crashed and loss == loss and abs(loss) < 1e4):
            failures.append(f"examples: train_lm crashed {crashed}, final "
                            f"loss {loss}")
    except Exception as exc:  # a failed example fails the phase, loudly
        import traceback
        traceback.print_exc()
        failures.append(f"examples: {type(exc).__name__}: {exc}")
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    _launch_check("examples", launches,
                  ("scale", "triad", "axpy", "spmv", "stencil", "attention"),
                  failures)
    bad = {k: v for k, v in errs.items() if not v <= F32_TOL}
    if bad:
        failures.append(f"examples: max_err above {F32_TOL}: {bad}")
    print(json.dumps({"phase": "examples", "max_err": errs, **out,
                      "launches": launches,
                      "phase_s": time.perf_counter() - t_phase,
                      "card": card}), flush=True)
    return launches


def _dryrun_phase(card, failures):
    """Phase 15, second half: the dry run of ``DRYRUN_ROWS`` in a
    subprocess (CPU only: CUDA_VISIBLE_DEVICES is empty, and the fake
    process group it starts stays out of this process), then its rows and
    ``launch.report``'s sections."""
    import os
    import subprocess
    from repro_torch.launch import report
    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_OUT.unlink(missing_ok=True)
    code = ("from repro_torch.launch import dryrun\n"
            f"for arch, cell in {DRYRUN_ROWS!r}:\n"
            "    dryrun.main(['--arch', arch, '--cell', cell, '--out', "
            f"{str(DRYRUN_OUT)!r}])\n")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
            text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                 "CUDA_VISIBLE_DEVICES": ""})
        rc, log = proc.returncode, (proc.stdout + proc.stderr).splitlines()
    except subprocess.TimeoutExpired:
        rc, log = "killed at its 600 s limit", []
    DRYRUN_OUT.with_suffix(".log").write_text("\n".join(log))
    rows = json.loads(DRYRUN_OUT.read_text()) if DRYRUN_OUT.exists() else []
    for r in rows:
        line = {"phase": "dryrun", "arch": r["arch"], "cell": r["cell"],
                "mesh": r["mesh"], "on": "meta tensors, CPU"}
        if "bytes_per_device" in r:
            line.update(gib_per_dev=r["bytes_per_device"]["total_gb"],
                        dominant=r["dominant"], t_bound_s=r["t_bound_s"],
                        trace_s=r["lower_compile_s"],
                        coll_bytes_by_kind=r["collectives"]["bytes_by_kind"],
                        coll_bf16_bytes_by_kind=r["collectives"][
                            "bf16_bytes_by_kind"])
        else:
            line["not_ok"] = r.get("error") or r.get("skipped")
            failures.append(f"dryrun {r['arch']}/{r['cell']}: "
                            f"{line['not_ok']}")
        print(json.dumps(line), flush=True)
    if rc != 0 or len(rows) != len(DRYRUN_ROWS):
        failures.append(f"dryrun: rc {rc}, {len(rows)} rows; log tail "
                        f"{log[-5:]}")
    rows.sort(key=lambda r: (r.get("arch", ""), r.get("cell", "")))
    print(report.dryrun_table(rows))
    print(report.roofline_table(rows))
    print(json.dumps({"phase": "dryrun_summary",
                      "summary": report.summary(rows), "rc": rc,
                      "wall_s": time.perf_counter() - t0, "card": card}),
          flush=True)


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
    20 executions each, twice in turns: the traced launch span records
    a CUDA event pair and takes the call's traits inside the timed
    window (the pairs resolve when the capture closes)."""
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
    """The dense models serve seeded traffic through run_session, once
    per flash-decode engine.

    Mistral-NeMo-12B at full width and depth (40 layers, d_model 5120, 32
    query heads over 8 KV heads, Dh 128), random float32 weights from
    SEED: about 49 GB on the card.  Then StableLM-2-12B at full width and
    depth (40 layers, d_model 5120, 32 query heads over 8 KV heads, Dh
    160, d_ff 13824, vocab 100352; 48.6 GB), both sessions on one set of
    weights: flash-decode at head dim 160.  The sessions' records are
    written to build/runs_torch and verified.  Returns {model: the
    flash-decode launches of its sessions, per kernel}.
    """
    from repro_torch.configs import get_arch
    out = {MODEL: _serve_model(torch, hw, card, failures, get_arch(MODEL),
                               ("vector", "matrix"), check="dense")}
    torch.cuda.empty_cache()
    out[MODEL_DH160] = _serve_model(torch, hw, card, failures,
                                    get_arch(MODEL_DH160),
                                    ("vector", "matrix"), check="dense",
                                    share_params=True)
    torch.cuda.empty_cache()
    return out


def _moe_phase(torch, hw, card, failures):
    """The MoE family served on the card (phase 8b).

    DeepSeek-V2-Lite-16B at full width and depth (MLA, 64 routed + 2
    shared experts, the first layer dense; ~63 GB float32): one session,
    since MLA decodes in latent space and launches no flash-decode, its
    decode step held against forward over the prompt plus that token.
    Qwen3-MoE-235B-A22B at full width (128 experts, top-8, 64 query heads
    over 4 KV heads: flash-decode at G = 16), cut to MOE_QWEN_LAYERS of its
    94 layers to fit the card: one session per flash-decode engine on the
    same weights, its decode step held against the dense-attention path.
    Returns {model: flash-decode launches per kernel}.
    """
    import dataclasses

    from repro_torch.configs import get_arch
    out = {}
    ds = get_arch("deepseek-v2-lite-16b")
    out[ds.name] = _serve_model(torch, hw, card, failures, ds, ("vector",),
                                check="forward")
    torch.cuda.empty_cache()
    full = get_arch("qwen3-moe-235b-a22b")
    qwen = dataclasses.replace(full, n_layers=MOE_QWEN_LAYERS)
    out[qwen.name] = _serve_model(
        torch, hw, card, failures, qwen, ("vector", "matrix"),
        check="dense", share_params=True,
        reduced={"n_layers": f"{MOE_QWEN_LAYERS} of {full.n_layers}"})
    torch.cuda.empty_cache()
    return out


def _ssm_phase(torch, hw, card, failures):
    """The SSM and hybrid families served on the card (phase 8c).

    Mamba2-780m at full width and depth (48 SSM layers, d_model 1536;
    ~3.4 GB float32): one session, since an SSM decodes from its recurrent
    state and launches no flash-decode, its chunked prefill and
    RECURRENT_STEPS recurrent steps held against forward.  Zamba2-7B at
    full width and depth (81 SSM layers, d_model 3584, the shared
    attention + SwiGLU block after every 6: flash-decode at 32 query over
    32 KV heads, G 1, Dh 112; ~27 GB): one session per flash-decode
    engine on one set of weights, its step held against the
    dense-attention path.  Both at a prompt of SSM_PROMPT_LEN.  Returns
    {model: flash-decode launches per kernel}.
    """
    from repro_torch.configs import get_arch
    out = {SSM_MODEL: _serve_model(torch, hw, card, failures,
                                   get_arch(SSM_MODEL), ("vector",),
                                   check="recurrent",
                                   prompt_len=SSM_PROMPT_LEN)}
    torch.cuda.empty_cache()
    hybrid = get_arch(HYBRID_MODEL)
    out[HYBRID_MODEL] = _serve_model(torch, hw, card, failures, hybrid,
                                     ("vector", "matrix"), check="dense",
                                     share_params=True,
                                     prompt_len=SSM_PROMPT_LEN)
    torch.cuda.empty_cache()
    _k4_model_points(torch, hw, card, failures, hybrid,
                     ((SSM_PROMPT_LEN, SSM_PROMPT_LEN),
                      (SSM_PROMPT_LEN + MAX_GEN,
                       SSM_PROMPT_LEN + MAX_GEN // 2)))
    return out


def _frontend_phase(torch, hw, card, failures):
    """The two multimodal-frontend families served on the card (phase 8d).

    SeamlessM4T-large-v2 at full width and depth (24 encoder + 24 decoder
    layers, d_model 1024, 16 heads of 64, G 1, d_ff 8192, vocab 256206;
    ~8.1 GB float32), each prompt's PROMPT_LEN audio frames through the
    encoder, every decoder layer's cross-attention on the cached encoder
    K / V: one session per flash-decode engine on one set of weights, its
    step held against the dense-attention path, and its prefill and
    TEACHER_STEPS teacher-forced steps against forward.  Qwen2-VL-72B at
    full width (64 query over 8 KV heads, Dh 128, d_ff 29568, vocab 152064,
    M-RoPE, 1024 patch positions) cut to VISION_LAYERS of its 80 layers:
    one session per engine on one set of weights, its step held against
    the dense-attention path.  Then K4 at both decode shapes.  Returns
    {model: flash-decode launches per kernel}.
    """
    import dataclasses

    from repro_torch.configs import get_arch
    seamless = get_arch(ENCDEC_MODEL)
    out = {seamless.name: _serve_model(
        torch, hw, card, failures, seamless, ("vector", "matrix"),
        check="dense", share_params=True, teacher_steps=TEACHER_STEPS)}
    torch.cuda.empty_cache()
    full = get_arch(VISION_MODEL)
    vision = dataclasses.replace(full, n_layers=VISION_LAYERS)
    out[vision.name] = _serve_model(
        torch, hw, card, failures, vision, ("vector", "matrix"),
        check="dense", share_params=True, prompt_len=VISION_PROMPT_LEN,
        reduced={"n_layers": f"{VISION_LAYERS} of {full.n_layers}"})
    torch.cuda.empty_cache()
    for cfg, prompt_len in ((seamless, PROMPT_LEN),
                            (vision, VISION_PROMPT_LEN)):
        s = prompt_len + MAX_GEN
        _k4_model_points(torch, hw, card, failures, cfg,
                         ((s, s), (s, prompt_len + MAX_GEN // 2)))
    return out


#: Phase 8f: (name, rows routed to each of the 20 held experts); "decode"
#: draws them, the rest are fixed.
EXPERT_ROUTINGS = (
    ("decode", None),
    ("three_each", [3] * 20),
    ("over_a_pass", [0, 1, 2, 3, 9, 17, 0, 5, 2, 2, 3, 1, 0, 4, 2, 2, 3, 1,
                     2, 1]),
    ("one_expert", [64] + [0] * 19),
)


def _experts_phase(torch, hw, card, failures):
    """The expert share's grouped SwiGLU on the card (phase 8f).

    DeepSeek-V2's widths, float32, seeded weights: 20 held experts of d
    5120, f 1536.  For each routing of ``EXPERT_ROUTINGS`` (``decode``:
    Poisson rows at 2.4 an expert, what the cell's share sees a layer),
    one call of ``kernels.experts.grouped_swiglu`` is one launch of
    ``_ext.experts`` and agrees with ``grouped_swiglu_plain`` within 1e-5 +
    1e-5 |b|; then the kernel and the plain version are timed by events,
    beside the bound of the bytes (each touched expert's weights once,
    each row's input, output and hidden once) and operations at the
    float32 peak.
    """
    from repro_torch.core.hw import dense_peak
    from repro_torch.core.timing import time_fn
    from repro_torch.kernels import _ext
    from repro_torch.kernels.experts import (grouped_swiglu,
                                             grouped_swiglu_plain)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    n, d, f = 20, 5120, 1536
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wg = torch.randn(n, d, f, generator=gen, device=dev) / d ** 0.5
    wu = torch.randn(n, d, f, generator=gen, device=dev) / d ** 0.5
    wd = torch.randn(n, f, d, generator=gen, device=dev) / f ** 0.5
    peak = dense_peak(hw, "float32")
    for name, counts in EXPERT_ROUTINGS:
        if counts is None:
            counts = torch.poisson(
                torch.full((n,), 2.4),
                generator=torch.Generator().manual_seed(SEED)).int().tolist()
        rows = sum(counts)
        offsets = torch.tensor([0] + counts, device=dev).cumsum(0).to(
            torch.int32)
        xs = torch.randn(rows + 5, d, generator=gen, device=dev)
        _ext.LAUNCHES["experts"] = 0
        got = grouped_swiglu(xs, offsets, wg, wu, wd)
        launches = _ext.LAUNCHES["experts"]
        want = grouped_swiglu_plain(xs, offsets, wg, wu, wd)
        torch.cuda.synchronize()
        err = (got[:rows] - want[:rows]).abs().max().item() if rows else 0.0
        ok = bool(torch.allclose(got[:rows], want[:rows], rtol=1e-5,
                                 atol=1e-5))
        if launches != 1 or not ok:
            failures.append(f"experts/{name}: {launches} launches, "
                            f"max_abs_err {err}")
        touched = sum(1 for c in counts if c)
        nbytes = 4 * (touched * 3 * d * f + rows * (2 * d + 2 * f))
        bound_ms = 1e3 * max(nbytes / hw.mem_bw, 2 * rows * 3 * d * f / peak)
        t = time_fn(grouped_swiglu, xs, offsets, wg, wu, wd, warmup=WARMUP,
                    iters=ITERS)
        plain = time_fn(grouped_swiglu_plain, xs, offsets, wg, wu, wd,
                        warmup=1, iters=5)
        ms = t.median_us / 1e3
        print(json.dumps({
            "phase": "experts", "routing": name, "rows": rows,
            "touched": touched, "most_rows": max(counts),
            "launches": launches, "max_abs_err": err, "ms": ms,
            "iqr_ms": t.iqr_us / 1e3, "plain_ms": plain.median_us / 1e3,
            "bound_ms": bound_ms, "share": bound_ms / ms}), flush=True)
    print(json.dumps({"phase": "experts_done",
                      "phase_s": time.perf_counter() - t_phase}), flush=True)
    del wg, wu, wd
    torch.cuda.empty_cache()


def _int8_phase(torch, hw, card, failures):
    """The int8 KV cache through flash-decode (phase 8e).

    Mistral-NeMo-12B at full width and depth, float32 (seeded random
    weights, ~49 GB), at the model phase's shape: one prefill of
    MODEL_BATCH prompts of PROMPT_LEN into float caches, whose rows are
    quantized into an int8 cache of PROMPT_LEN + MAX_GEN with the step's
    own ``_int8_cache_update``.  Then, per flash-decode engine, MAX_GEN
    decode steps on the int8 cache through the kernel, each held against
    the dense-attention path on a copy of the same int8 cache (1e-4 +
    1e-3 |b|), launches counted; the same tokens on the float32 cache give
    the logit gap and the greedy agreement the quantization costs
    (information, not a gate).  Last, one attention layer's cache read at
    the STREAM point (S 32768, kv_len 28672) from a float32 and from an
    int8 cache (``int8_k4_point`` lines).  Returns {key: flash-decode
    launches per kernel}.
    """
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _ext
    from repro_torch.models import lm
    from repro_torch.models.attention import _int8_cache_update
    from repro_torch.models.engine import DecodeEngine
    cfg = get_arch(MODEL)
    max_len = PROMPT_LEN + MAX_GEN
    print(f"int8 cache: {cfg.name} at full width and depth, batch "
          f"{MODEL_BATCH}, prompt {PROMPT_LEN}, {MAX_GEN} steps from an "
          f"int8 cache of {max_len}", flush=True)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches = {}
    for engine in ("vector", "matrix"):
        other = "matrix" if engine == "vector" else "vector"
        kw = dict(max_batch=MODEL_BATCH, prompt_len=PROMPT_LEN,
                  max_gen=MAX_GEN, dtype=torch.float32, engine=engine,
                  params=params)
        eng = DecodeEngine(cfg, **kw)
        dense = DecodeEngine(cfg, attention_impl="dense", **kw)
        batch = eng.make_prompt_batch(seed=SEED)
        logits, floats = eng.prefill(batch)
        q8 = lm.init_caches(cfg, MODEL_BATCH, max_len, dtype=torch.int8,
                            device="cuda")
        for i in range(cfg.n_layers):
            _int8_cache_update({n: c[i] for n, c in q8["attn"].items()},
                               floats["attn"]["k"][i, :, :PROMPT_LEN],
                               floats["attn"]["v"][i, :, :PROMPT_LEN], 0)
        twin = eng.cache_state(q8)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        fed, got_logits, err, within = [], [], 0.0, True
        torch.cuda.synchronize()
        _ext.reset_launches()
        t0 = time.perf_counter()
        for at in range(PROMPT_LEN, max_len):
            got, q8 = eng.decode_step(tok, q8, at)
            want, twin = dense.decode_step(tok, twin, at)
            err = max(err, (got - want).abs().max().item())
            within = within and torch.allclose(got, want, rtol=STEP_RTOL,
                                               atol=STEP_ATOL)
            fed.append(tok)
            got_logits.append(got[:, 0])
            tok = torch.argmax(got[:, 0], dim=-1)[:, None]
        torch.cuda.synchronize()
        pair_s = time.perf_counter() - t0
        counts = dict(_ext.LAUNCHES)
        launches[f"attention_{engine}"] = counts.get(f"attention_{engine}",
                                                     0)
        launches.setdefault(f"attention_{other}", 0)
        want_n = cfg.n_layers * MAX_GEN
        if launches[f"attention_{engine}"] != want_n:
            failures.append(f"int8 cache {cfg.name}/{engine}: "
                            f"{launches[f'attention_{engine}']} flash-decode "
                            f"launches, expected {want_n}")
        if counts.get(f"attention_{other}", 0):
            failures.append(f"int8 cache {cfg.name}/{engine}: the {other} "
                            f"kernel ran {counts[f'attention_{other}']} times")
        if not within:
            failures.append(f"int8 cache {cfg.name}/{engine}: a step differs "
                            f"from the dense path on the same int8 cache by "
                            f"{err}")
        del twin
        # the same tokens on the float32 cache of the same prefill
        gap, agree = 0.0, 0.0
        for at, t, l8 in zip(range(PROMPT_LEN, max_len), fed, got_logits):
            lf, floats = eng.decode_step(t, floats, at)
            gap = max(gap, (l8 - lf[:, 0]).abs().max().item())
            agree += (torch.argmax(l8, dim=-1) == torch.argmax(
                lf[:, 0], dim=-1)).float().mean().item() / MAX_GEN
        print(json.dumps({
            "phase": "int8_cache", "model": cfg.name, "engine": engine,
            "steps": MAX_GEN, "init_s": init_s,
            "flash_decode_launches": launches[f"attention_{engine}"],
            "other_engine_launches": counts.get(f"attention_{other}", 0),
            "step_vs_dense_max_abs_err": err, "step_within": within,
            "int8_and_dense_steps_s": pair_s,
            "logit_gap_vs_float32_cache": gap,
            "greedy_agree_vs_float32_cache": agree,
            "card": card}), flush=True)
        del eng, dense, q8, floats, logits, got_logits, got, want, batch
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    _int8_k4_point(torch, hw, card, failures, cfg)
    return {f"{MODEL}/int8": launches}


def _int8_k4_point(torch, hw, card, failures, cfg):
    """One attention layer's cache read at Mistral-NeMo-12B's decode shape
    (B MODEL_BATCH, KH 8, G 4, Dh 128) at the STREAM point (S 32768,
    kv_len 28672), on both engines: ``_attend_cache`` as a decode step
    calls it, from a float32 cache (the row written, flash-decode over it)
    and from an int8 cache (the row quantized, the whole cache dequantized
    into float32, flash-decode over that).  Device time (torch.profiler),
    CUDA-event median, each beside the bytes it must move; each output
    held against the dense path on the same cache."""
    from repro_torch.core.timing import time_fn
    from repro_torch.models.attention import (_attend_cache,
                                              _int8_cache_update, make_cache)
    b, kh, dh, s = MODEL_BATCH, cfg.n_kv_heads, cfg.head_dim, 32768
    at = 7 * s // 8 - 1                   # this step's row: kv_len 28672
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    caches = {"float32": make_cache(cfg, b, s, torch.float32, "cuda"),
              "int8": make_cache(cfg, b, s, torch.int8, "cuda")}
    for name in ("k", "v"):
        rows = torch.randn((b, at, kh, dh), generator=gen, device="cuda")
        caches["float32"][name][:, :at] = rows
        del rows
    _int8_cache_update(caches["int8"], caches["float32"]["k"][:, :at],
                       caches["float32"]["v"][:, :at], 0)
    q = torch.randn((b, 1, cfg.n_heads, dh), generator=gen, device="cuda")
    k, v = (torch.randn((b, 1, kh, dh), generator=gen, device="cuda")
            for _ in range(2))
    pos = torch.full((b, 1), at, dtype=torch.int32, device="cuda")
    kv_bytes = 2 * b * (at + 1) * kh * dh * 4       # flash-decode's read
    moved = {"float32": kv_bytes,
             # + int8 k / v and their scales read over S, float32 written
             "int8": kv_bytes + 2 * b * s * kh * (dh + 4 + dh * 4)}
    dense_cfg = dataclasses.replace(cfg, decode_attention_impl="dense")
    device_ms = {}
    for engine in ("vector", "matrix"):
        ecfg = dataclasses.replace(cfg, decode_attention_impl="registry",
                                   decode_attention_engine=engine)
        for kind, cache in caches.items():
            def fn(cache=cache, ecfg=ecfg):
                return _attend_cache(q, k, v, cache, at, ecfg, pos)
            got = fn()
            want = _attend_cache(q, k, v, cache, at, dense_cfg, pos)
            err = (got - want).abs().max().item()
            if not err <= F32_TOL:
                failures.append(f"int8 K4 point {kind}/{engine}: "
                                f"max_abs_err {err} against the dense path")
            t = time_fn(fn, warmup=WARMUP, iters=ITERS)
            host_us, device_us = _host_and_device_us(torch, fn, calls=20)
            bound_ms = moved[kind] / hw.mem_bw * 1e3
            device_ms[(engine, kind)] = (device_us / 1e3 if device_us !=
                                         "not measured" else device_us)
            print(json.dumps({
                "phase": "int8_k4_point", "model": cfg.name,
                "cache": kind, "engine": engine,
                "point": f"B{b} KH{kh} G{cfg.n_heads // kh} Dh{dh} S{s} "
                         f"kv_len {at + 1}",
                "median_us": t.median_us, "iqr_us": t.iqr_us,
                "profiler_device_us": device_us, "host_enqueue_us": host_us,
                "bytes": moved[kind], "bound_ms": bound_ms,
                "bound_by": "bytes", "max_abs_err": err, "card": card}),
                flush=True)
        f32, i8 = device_ms[(engine, "float32")], device_ms[(engine, "int8")]
        if isinstance(f32, float) and isinstance(i8, float):
            print(json.dumps({"phase": "int8_k4_ratio", "engine": engine,
                              "device_ms_int8_over_float32": i8 / f32,
                              "bytes_int8_over_float32":
                                  moved["int8"] / moved["float32"],
                              "card": card}), flush=True)
    del caches, q, k, v, got, want
    torch.cuda.empty_cache()


def _train_phase(torch, hw, card, failures):
    """Training on the card (phase 14).

    Mistral-NeMo-12B at full width on TRAIN_LAYERS of its 40 layers
    (float32, TF32 off; seeded random weights), TRAIN_BATCH x TRAIN_SEQ
    tokens a step from ``TokenPipeline``, AdamW on
    ``cosine_schedule(3e-4, 10, TRAIN_STEPS)``, remat on.  Checks: step
    0's loss against the masked NLL of ``forward``'s logits
    (``F.cross_entropy``) within 1e-5; step 0's gradients with remat on
    and off, leaf for leaf, within 1e-6 + 1e-5 |b|; step 1's AdamW update
    of ``final_norm`` and layer 0's ``wq`` against the same update on the
    CPU (the global norm summed there from every gradient) within 1e-6 +
    1e-5 |b|; every loss finite; the loss of batch 0 after TRAIN_STEPS
    steps below step 0's; one more step with int8 gradient compression,
    its compressed leaves equal to the CPU's ``_q_int8`` of the same
    gradients.  Prints step time, device time, peak memory, tokens/s and
    6 N D over the float32 CUDA-core peak.  Then the restart drill at
    ``reduced("deepseek-7b")`` under deterministic algorithms, and
    ``python -m repro_torch.launch.train`` as a subprocess.
    """
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.core.timing import busy_us
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step, make_value_and_grad
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.optim.compression import _q_int8, compress_in_place
    from repro_torch.optim.tree import named_leaves

    full = get_arch(MODEL)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    n_params = cfg.param_count()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"train: {cfg.name} at full width, {TRAIN_LAYERS} of "
          f"{full.n_layers} layers ({n_params / 1e9:.2f} B float32 "
          f"parameters), batch {TRAIN_BATCH} x {TRAIN_SEQ}, AdamW, remat",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    params = lm.init_params(cfg, seed=SEED, device="cuda")
    pipe = TokenPipeline(cfg, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         device="cuda")
    batch0 = pipe.batch(0)

    def close(a, b):
        return bool(((a - b).abs() <= 1e-6 + 1e-5 * b.abs()).all())

    # step 0's gradients, remat on and off: remat changes no value
    value_and_grad = make_value_and_grad(cfg, dtype=torch.float32)
    (loss0, _), grads = value_and_grad(params, batch0)
    (_, _), no_remat = make_value_and_grad(cfg, dtype=torch.float32,
                                           remat=False)(params, batch0)
    remat_err, remat_ok = 0.0, True
    for (name, a), (_, b) in zip(named_leaves(grads),
                                 named_leaves(no_remat)):
        remat_err = max(remat_err, (a - b).abs().max().item())
        remat_ok = remat_ok and close(a, b)
    del grads, no_remat
    if not remat_ok:
        failures.append(f"train {cfg.name}: step 0's gradients with remat "
                        f"differ from those without by {remat_err}")
    # step 0's loss against the masked NLL of forward's logits
    with torch.no_grad():
        logits, _, _ = lm.forward(params, cfg, batch0, dtype=torch.float32,
                                  remat=False)
        nll = F.cross_entropy(logits.flatten(0, 1),
                              batch0["labels"].long().flatten(),
                              reduction="none").view(TRAIN_BATCH, TRAIN_SEQ)
        mask = batch0["loss_mask"]
        want0 = ((nll * mask).sum() / mask.sum().clamp_min(1.0)).item()
        del logits, nll
    loss_err = abs(loss0.item() - want0)
    if not loss_err <= 1e-5:
        failures.append(f"train {cfg.name}: step 0's loss {loss0.item()} "
                        f"differs from forward's masked NLL {want0} by "
                        f"{loss_err}")

    opt = AdamW(lr=cosine_schedule(3e-4, 10, TRAIN_STEPS))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, dtype=torch.float32)
    losses, step_s, adam_err, adam_ok = [], [], None, None
    for step in range(TRAIN_STEPS):
        batch = pipe.batch(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step != 1:
            params, state, metrics = step_fn(params, state, batch)
            loss = metrics["loss"]
        else:
            # the train step's pieces, the update held against the CPU's
            (loss, _), grads = value_and_grad(params, batch)
            params, state, adam_err, adam_ok = _adamw_against_cpu(
                torch, opt, grads, state, params,
                ("final_norm", "layers.0.attn.wq"))
            del grads
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        failures.append(f"train {cfg.name}: losses {losses}")
    if not adam_ok:
        failures.append(f"train {cfg.name}: step 1's AdamW update differs "
                        f"from the CPU's by {adam_err}")
    with torch.no_grad():
        replay, _ = lm.loss_fn(params, cfg, batch0, dtype=torch.float32)
    replay = replay.item()
    if not replay < loss0.item():
        failures.append(f"train {cfg.name}: batch 0's loss {replay} after "
                        f"{TRAIN_STEPS} steps is not below step 0's "
                        f"{loss0.item()}")
    # one more step under torch.profiler: where its device time goes
    batch = pipe.batch(TRAIN_STEPS)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        params, state, metrics = step_fn(params, state, batch)
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = busy_us((a, b) for _, a, b in spans) / 1e3
    by_name = {}
    for n, a, b in spans:
        by_name[n[:90]] = by_name.get(n[:90], 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    del prof
    # one more with int8 gradient compression: the train step's pieces
    batch = pipe.batch(TRAIN_STEPS + 1)
    (loss, _), grads = value_and_grad(params, batch)
    named = dict(named_leaves(grads))
    host = {n: named[n].cpu() for n in ("final_norm", "layers.0.attn.wq")}
    compress_in_place(grads, "int8")
    compress_ok = all(torch.equal(named[n].cpu(), _q_int8(g))
                      for n, g in host.items())
    params, state = opt.update(grads, state, params)
    del grads, named
    if not (compress_ok and bool(torch.isfinite(loss))):
        failures.append(f"train {cfg.name}: int8-compressed step: leaves "
                        f"equal to the CPU's {compress_ok}, loss "
                        f"{loss.item()}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    median_s = sorted(step_s[2:])[len(step_s[2:]) // 2]
    flops = 6.0 * n_params * tokens
    print(json.dumps({
        "phase": "train", "model": cfg.name,
        "reduced": {"n_layers": f"{TRAIN_LAYERS} of {full.n_layers}"},
        "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "losses": losses, "replayed_batch0_loss": replay,
        "loss0_vs_forward_nll_err": loss_err,
        "remat_grads_max_abs_err": remat_err,
        "adamw_vs_cpu_max_abs_err": adam_err,
        "int8_compressed_leaves_equal_cpu": compress_ok,
        "step_s": step_s, "median_step_s_2_to_5": median_s,
        "device_ms_one_step": device_ms or "not measured",
        "kernels_one_step": len(spans),
        "top_kernels_ms": top,
        "tokens_per_s": tokens / median_s,
        "model_flops_6ND": flops,
        "flops_share_of_fp32_peak": flops / median_s / PEAK_OPS,
        "fp32_peak_source": "67 TFLOP/s, H100 SXM float32 outside the "
                            "tensor cores (NVIDIA datasheet)",
        "peak_memory_gb": peak_gb, "phase_s": time.perf_counter() - t_phase,
        "card": card}), flush=True)
    del params, state, metrics, batch, batch0, loss0, value_and_grad
    del step_fn
    torch.cuda.empty_cache()
    _restart_drill(torch, failures, card)
    _launch_train(failures)


def _adamw_against_cpu(torch, opt, grads, state, params, names):
    """``opt.update`` on the card, and the same update of the leaves
    ``names`` on the CPU from copies of their gradients, moments and
    weights, the clip scale from every gradient summed on the CPU.
    Returns (params, the new state, largest gap, all within 1e-6 + 1e-5
    |b|)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.tree import leaves, named_leaves

    def pick(tree):
        named = dict(named_leaves(tree))
        return {n: named[n].detach().cpu().clone() for n in names}
    sq = torch.zeros(())
    for g in leaves(grads):
        sq = sq + torch.sum(torch.square(g.detach().cpu()))
    scale = torch.clamp_max(opt.clip_norm / (torch.sqrt(sq) + 1e-9), 1.0)
    cpu_g = {n: g * scale for n, g in pick(grads).items()}
    cpu_p = pick(params)
    cpu_state = AdamWState(state.count.cpu(), pick(state.m), pick(state.v))
    cpu_opt = dataclasses.replace(opt, clip_norm=None)
    cpu_p, cpu_state = cpu_opt.update(cpu_g, cpu_state, cpu_p)
    params, state = opt.update(grads, state, params)
    err, ok = 0.0, True
    for got_tree, want in ((params, cpu_p), (state.m, cpu_state.m),
                           (state.v, cpu_state.v)):
        got = pick(got_tree)
        for n in names:
            a, b = got[n], want[n]
            err = max(err, (a - b).abs().max().item())
            ok = ok and bool(((a - b).abs() <= 1e-6 + 1e-5 * b.abs()).all())
    return params, state, err, ok


def _restart_drill(torch, failures, card):
    """``tests/test_fault_tolerance.py``'s drill on the card at
    ``reduced("deepseek-7b")``: ten steps straight against a crash at step
    7 and a resume from step 6's checkpoint, the parameters and moments
    bit for bit, under ``torch.use_deterministic_algorithms(True)`` (the
    embedding's backward accumulates with atomics otherwise), set for the
    drill alone with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``."""
    import os

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.tree import leaves
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.train_loop import (FailureInjector,
                                                TrainLoopConfig, run)
    cfg = reduced(get_arch("deepseek-7b"))
    opt = AdamW(lr=1e-3, clip_norm=1.0)
    pipe = TokenPipeline(cfg, global_batch=4, seq=32, device="cuda")
    step_fn = make_train_step(cfg, opt, dtype=torch.float32)

    def init_state():
        params = lm.init_params(cfg, seed=SEED, device="cuda")
        return params, opt.init(params)
    root = ROOT / "build" / "train_drill"
    shutil.rmtree(root, ignore_errors=True)
    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    try:
        lc = TrainLoopConfig(total_steps=10, ckpt_every=3, log_every=100,
                             ckpt_dir=str(root / "a"), async_ckpt=False)
        straight = run(lc, init_state=init_state, step_fn=step_fn,
                       batch_fn=pipe.batch, log=lambda *_: None)
        # both legs write synchronously, as the reference's drill does: an
        # asynchronous step-6 save races the crash at step 7
        lc2 = dataclasses.replace(lc, ckpt_dir=str(root / "b"))
        try:
            run(lc2, init_state=init_state, step_fn=step_fn,
                batch_fn=pipe.batch,
                injector=FailureInjector(fail_at_step=7),
                log=lambda *_: None)
            crashed = False
        except RuntimeError as exc:
            if "injected failure" not in str(exc):
                raise
            crashed = True
        resumed_at = ckpt.latest_step(root / "b")
        resumed = run(lc2, init_state=init_state, step_fn=step_fn,
                      batch_fn=pipe.batch, log=lambda *_: None)
    finally:
        torch.use_deterministic_algorithms(False)
        if saved is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved
    equal = {what: all(torch.equal(a, b) for a, b in
                       zip(leaves(x), leaves(y)))
             for what, x, y in (("params", straight[0], resumed[0]),
                                ("m", straight[1].m, resumed[1].m),
                                ("v", straight[1].v, resumed[1].v))}
    print(json.dumps({"phase": "restart_drill", "model": cfg.name,
                      "crashed_at_7": crashed, "resumed_from": resumed_at,
                      "bit_equal": equal,
                      "final_loss": float(resumed[2]["loss"]),
                      "drill_s": time.perf_counter() - t0, "card": card}),
          flush=True)
    if not (crashed and resumed_at == 6 and all(equal.values())):
        failures.append(f"restart drill {cfg.name}: crashed {crashed}, "
                        f"resumed from {resumed_at}, bit-equal {equal}")
    del straight, resumed
    torch.cuda.empty_cache()


def _launch_train(failures):
    """``python -m repro_torch.launch.train`` on the card, as a user runs
    it: reduced DeepSeek-7B, 2 steps of 2 x 16."""
    import os
    import subprocess
    ckpts = ROOT / "build" / "train_launch"
    shutil.rmtree(ckpts, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "deepseek-7b", "--reduced", "--steps", "2", "--batch", "2",
           "--seq", "16", "--ckpt-dir", str(ckpts)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env={**os.environ,
                                            "PYTHONPATH": str(ROOT / "src")})
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-4:]
    print(json.dumps({"phase": "launch_train", "rc": proc.returncode,
                      "wall_s": time.perf_counter() - t0, "tail": tail}),
          flush=True)
    if proc.returncode != 0 or "done: loss=" not in proc.stdout:
        failures.append(f"launch.train: rc {proc.returncode}: {tail}")


def _k4_model_points(torch, hw, card, failures, cfg, points):
    """Flash-decode at ``cfg``'s decode shape (B MODEL_BATCH, its KV heads,
    query heads per KV head and head dim) on both engines, through the
    registry op as its decode step calls it, at each (S, kv_len) of
    ``points``: CUDA-event median and IQR, profiler device time, the
    host's enqueue time, the error against the plain version, the
    valid-bytes bound and SDPA on the same valid positions.  At each S,
    the kv_len edges (1, around 64 and block_s, S - 1, S) are held against
    the plain version and bit for bit against the same kernel reading
    every position.  These launches time and check the kernel; they are
    not the main path's."""
    import torch.nn.functional as F

    from repro_torch.bench.bench_kernels import bound_work
    from repro_torch.core.timing import time_fn
    from repro_torch.kernels import _ext
    from repro_torch.kernels.attention.flash_decode import flash_decode_plain
    from repro_torch.kernels.attention.ops import (DEFAULT_BLOCK_S,
                                                   _clamp_block_s,
                                                   decode_attention)
    b, kh, dh = MODEL_BATCH, cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for s, kv_len in points:
        q = torch.randn((b, kh, g, dh), generator=gen, device="cuda")
        k = torch.randn((b, s, kh, dh), generator=gen, device="cuda")
        v = torch.randn((b, s, kh, dh), generator=gen, device="cuda")
        args = (q, k, v, kv_len)
        traffic, _ = bound_work("attention", args, None)
        bound_ms = traffic / hw.mem_bw * 1e3
        block_s = _clamp_block_s(s, DEFAULT_BLOCK_S)
        sdpa = _library_fn(torch, F, "attention", args, {})
        sdpa_ms = time_fn(sdpa, warmup=WARMUP, iters=ITERS).median_us / 1e3
        _, sdpa_device_us = _host_and_device_us(torch, sdpa)
        point = f"B{b} KH{kh} G{g} Dh{dh} S{s} kv_len {kv_len}"
        edges = sorted({e for e in (1, 63, 64, 65, block_s - 1, block_s,
                                    block_s + 1, s - 1, s) if 1 <= e <= s})
        for engine in ("vector", "matrix"):
            bad = []
            for e in edges:
                got = decode_attention(q, k, v, e, engine=engine)
                rows = _ext.attention_ranges(s, block_s, b * kh, sms, e,
                                             q.dtype, g, engine,
                                             q.shape[-1])[0]
                full = _ext.attention_launch(q, k, v, e, rows=rows,
                                             nsplit=-(-s // rows), end=s,
                                             engine=engine)
                want = flash_decode_plain(q, k, v, e, block_s=block_s,
                                          engine=engine)
                if not (torch.equal(got, full) and
                        (got - want).abs().max().item() <= F32_TOL):
                    bad.append(e)
            if bad:
                failures.append(f"K4 at {cfg.name}'s point {point}/{engine}: "
                                f"kv_len {bad} differ from the full read or "
                                f"the plain version")

            def fn(engine=engine):
                return decode_attention(q, k, v, kv_len, engine=engine)
            got = fn()
            want = flash_decode_plain(q, k, v, kv_len, block_s=block_s,
                                      engine=engine)
            err = (got - want).abs().max().item()
            if not err <= F32_TOL:
                failures.append(f"K4 at {cfg.name}'s point {point}/{engine}: "
                                f"max_abs_err {err} against the plain "
                                f"version")
            t = time_fn(fn, warmup=WARMUP, iters=ITERS)
            plain = time_fn(lambda: flash_decode_plain(
                q, k, v, kv_len, block_s=block_s, engine=engine),
                warmup=1, iters=5)
            host_us, device_us = _host_and_device_us(torch, fn)
            print(json.dumps({
                "phase": "model_k4_point", "model": cfg.name,
                "point": point, "engine": engine, "block_s": block_s,
                "kv_len_edges": edges, "kv_len_edges_failed": bad,
                "median_us": t.median_us, "iqr_us": t.iqr_us,
                "profiler_device_us": device_us,
                "host_enqueue_us": host_us, "bound_ms": bound_ms,
                "bound_by": "bytes",
                "bw_share": bound_ms * 1e3 / t.median_us,
                "max_abs_err": err, "plain_ms": plain.median_us / 1e3,
                "sdpa_ms": sdpa_ms,
                "sdpa_device_ms": (sdpa_device_us / 1e3 if sdpa_device_us
                                   != "not measured" else sdpa_device_us),
                "card": card}), flush=True)
        del q, k, v, args, got, want, full, sdpa
        torch.cuda.empty_cache()


def _moe_device_ms(torch, eng, cfg):
    """Device time of one decode step's MoE FFNs (ms): every MoE layer's
    moe_ffn on a (B, 1, D) input drawn from SEED, torch.profiler's busy
    time (the union of the kernels' intervals) per pass.  Every expert
    runs whatever the routing, so the time does not depend on the input's
    values."""
    from repro_torch.core.timing import device_busy_us
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.moe import moe_ffn
    layers = [layer for layer in eng.params.layers if layer.moe is not None]
    if not layers:
        return 0.0
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((eng.max_batch, 1, cfg.d_model), generator=gen,
                    device="cuda")
    xs = [rmsnorm(layer.ln2, x, cfg.norm_eps) for layer in layers]

    @torch.no_grad()
    def moe_pass():
        for layer, xn in zip(layers, xs):
            moe_ffn(layer.moe, xn, cfg)
    moe_pass()
    torch.cuda.synchronize()
    return device_busy_us(moe_pass, calls=3) / 1e3


def _teacher_forced(torch, eng, batch, steps, logits, caches):
    """``eng``'s prefill logits (``logits``, ``caches``: a prefill of
    ``batch``) and ``steps`` teacher-forced decode steps on those caches,
    each held to 1e-4 + 1e-3 |b| against forward over the prompt and the
    tokens before it, at the step's position; the batch's other inputs
    (an encoder's frames) as they are.  The tokens are drawn from SEED + 1.
    Returns (largest gap, all within, the last step's logits)."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import lm
    prompt_len = batch["tokens"].shape[1]
    extra = make_batch(eng.cfg, eng.max_batch, steps, seed=SEED + 1,
                       device="cuda")["tokens"]
    seq = torch.cat([batch["tokens"], extra], dim=1)
    want, _, _ = lm.forward(eng.params, eng.cfg, dict(batch, tokens=seq),
                            dtype=torch.float32)
    step = logits[:, 0]
    gaps = [(step, want[:, prompt_len - 1])]
    for i in range(steps):
        at = prompt_len + i
        step, _ = eng.decode_step(seq[:, at:at + 1], caches, at)
        gaps.append((step[:, 0], want[:, at]))
    err = max((a - b).abs().max().item() for a, b in gaps)
    within = all(torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL)
                 for a, b in gaps)
    return err, within, step


def _serve_model(torch, hw, card, failures, cfg, engines, *, check,
                 share_params=False, reduced=None, prompt_len=PROMPT_LEN,
                 teacher_steps=0):
    """``cfg`` serves the reference's ``serve --workload lm`` traffic
    through run_session, once per flash-decode engine in ``engines``.

    Per session: launches held against the log (one flash-decode launch
    per layer that runs it and decode step, of each batch and of the
    warm-up: none for MLA or an SSM), greedy tokens, teacher-forced
    decode steps held to 1e-4 + 1e-3 |b| against ``check``: "dense" (one
    step, the same step on the dense-attention path), "forward" (the
    served engine's step on the caches of a prefill with the MoE capacity
    lifted so that no expert overflows, against forward over the prompt
    plus that token, lifted too, as drops exist only in the batched pass)
    or "recurrent" (the chunked prefill's last logits and RECURRENT_STEPS
    recurrent steps, each against forward over the prompt and all those
    tokens at its position), one profiled step, and the step beside two
    bounds: the traits' bytes (the experts a step touches; a hybrid's
    shared block once per application) and every weight once.
    ``teacher_steps`` adds, on a prefill of its own, the prefill's last
    logits and that many teacher-forced steps against forward, as
    "recurrent" does.  ``share_params`` draws the weights once for all
    engines; ``prompt_len`` is the prompt's length (an SSM's: a multiple
    of its chunk).  The records are written to build/runs_torch and
    verified.
    Returns the sessions' flash-decode launches per kernel.
    """
    from repro_torch.bench.common import bench_env, write_serving_json
    from repro_torch.core.dispatch import DEFAULT_DISPATCHER
    from repro_torch.core.timing import busy_us
    from repro_torch.kernels import _ext
    from repro_torch.models.advisor_map import step_traits
    from repro_torch.models.engine import DecodeEngine
    from repro_torch.report import check_records, load_file, violations
    from repro_torch.serving import (SLO, BatchPolicy, PoissonLoadGen,
                                     SessionConfig, run_session)
    from repro_torch.serving.lm import LMDecodeExecutor

    steps = MAX_GEN - 1                 # decode steps per generation
    max_len = prompt_len + MAX_GEN
    step_bytes = step_traits(cfg, MODEL_BATCH, max_len,
                             dtype_bytes=4).traffic_bytes
    step_bound_ms = step_bytes / hw.mem_bw * 1e3
    gqa = (f"{cfg.n_heads} query / {cfg.n_kv_heads} KV heads, head_dim "
           f"{cfg.head_dim}")
    ssm = (f"d_inner {cfg.d_inner}, {cfg.ssm_nheads} SSM heads of "
           f"{cfg.ssm_headdim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    if cfg.family == "ssm":
        attn, ffn = "attention-free", ssm
    elif cfg.family == "hybrid":
        attn = (f"one shared attention + SwiGLU block after every "
                f"{cfg.attn_every} SSM layers ({gqa}, d_ff {cfg.d_ff})")
        ffn = ssm
    else:
        attn = (f"MLA (kv_lora_rank {cfg.kv_lora_rank})" if cfg.use_mla
                else gqa)
        if cfg.enc_dec:
            attn += (f", a {cfg.n_enc_layers}-layer encoder of audio frames "
                     f"({cfg.frontend_dim} wide) and cross-attention")
        if cfg.frontend == "vision":
            attn += (f", M-RoPE {tuple(cfg.mrope_sections)}, "
                     f"{cfg.frontend_len} patch positions of "
                     f"{cfg.frontend_dim}")
        ffn = (f"{cfg.n_experts} experts top-{cfg.top_k}"
               + (f" + {cfg.n_shared_experts} shared"
                  if cfg.n_shared_experts else "")
               + (f", {cfg.first_dense_layers} dense first" if
                  cfg.first_dense_layers else "") if cfg.n_experts else
               f"d_ff {cfg.d_ff}")
    print(f"model: {cfg.name} at full width"
          f"{' and depth' if reduced is None else f', reduced {reduced}'} "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}, {attn}, {ffn}, "
          f"{cfg.param_count() / 1e9:.2f} B float32 parameters), batch "
          f"{MODEL_BATCH}, prompt {prompt_len}, {MAX_GEN} tokens, cache "
          f"{max_len}", flush=True)
    kernel = f"lm-{cfg.name}"
    launches, tokens, records = {}, {}, []
    params = None
    torch.cuda.reset_peak_memory_stats()
    for engine in engines:
        other = "matrix" if engine == "vector" else "vector"
        t0 = time.perf_counter()
        ex = LMDecodeExecutor(cfg, max_batch=MODEL_BATCH,
                              prompt_len=prompt_len, max_gen=MAX_GEN,
                              dtype=torch.float32, seed=SEED, engine=engine,
                              verdict_cfg=cfg, params=params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eng = ex.engine
        if share_params:
            params = eng.params
        mem_gb = torch.cuda.memory_allocated() / 1e9
        weights_bytes = sum(t.numel() * t.element_size()
                            for t in eng.params.parameters())
        weights_ms = weights_bytes / hw.mem_bw * 1e3
        per_gen = eng.flash_decode_layers * steps
        fd_engine = (engine if eng.flash_decode_layers else
                     "not applicable: an SSM decodes from its recurrent "
                     "state, no flash-decode" if cfg.family == "ssm" else
                     "not applicable: MLA decodes in latent space, no "
                     "flash-decode")
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
                f"model {cfg.name}/{engine}: "
                f"{launches[f'attention_{engine}']} flash-decode launches "
                f"for {len(log.batches)} batches, expected {want} (one per "
                f"flash-decode layer and decode step of each batch and of "
                f"the warm-up)")
        if counts.get(f"attention_{other}", 0):
            failures.append(f"model {cfg.name}/{engine}: the {other} kernel "
                            f"ran {counts[f'attention_{other}']} times")
        if record["engine"] != engine or log.completed != log.offered:
            failures.append(f"model {cfg.name}/{engine}: engine "
                            f"{record['engine']}, {log.completed}/"
                            f"{log.offered} served")
        records.append(record)
        extras = record["phases"]
        per_step_ms = extras["per_step_ms"]
        prefill_ms = extras["prefill_ms"] / extras["launches"]
        print(json.dumps({
            "phase": "model_serving", "kernel": kernel, "engine": engine,
            "flash_decode_engine": fd_engine,
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
        batch = eng.make_prompt_batch(seed=SEED)
        result = eng.generate(batch)
        # the same generation outside the session's trace capture, where
        # no launch span synchronizes
        untraced_step_ms = result.per_step_s * 1e3
        tokens[engine] = result.tokens.cpu()
        if tuple(result.tokens.shape) != (MODEL_BATCH, MAX_GEN) or \
                not bool(torch.isfinite(result.logits).all()):
            failures.append(f"model {cfg.name}/{engine}: tokens "
                            f"{tuple(result.tokens.shape)}, finite logits "
                            f"{bool(torch.isfinite(result.logits).all())}")
        del result

        # one teacher-forced step of the served engine `eng`, same
        # weights, held as `step` against `want`
        logits, caches = eng.prefill(batch)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if check == "dense":
            # through the kernel against the plain dense-attention path,
            # on the same caches
            twin = eng.cache_state(caches)
            step, _ = eng.decode_step(tok, caches, prompt_len)
            ref = DecodeEngine(cfg, max_batch=MODEL_BATCH,
                               prompt_len=prompt_len, max_gen=MAX_GEN,
                               dtype=torch.float32, engine=engine,
                               attention_impl="dense", params=eng.params)
            want, _ = ref.decode_step(tok, twin, prompt_len)
            del twin
            # the profiled step below is the next one on these caches
            tok, at = torch.argmax(step[:, 0], dim=-1)[:, None], \
                prompt_len + 1
            against = "dense_attention_path"
        elif check == "recurrent":
            # the chunked prefill above, then RECURRENT_STEPS
            # teacher-forced recurrent steps, each against forward
            # (chunked) over the prompt and every token, at the step's
            # position
            ref = want = None
            step_err, within, step = _teacher_forced(
                torch, eng, batch, RECURRENT_STEPS, logits, caches)
            # the profiled step below is the next one on these caches
            tok, at = (torch.argmax(step[:, 0], dim=-1)[:, None],
                       prompt_len + RECURRENT_STEPS)
            against = (f"forward_over_prompt_plus_{RECURRENT_STEPS}_tokens_"
                       f"at_each_of_{RECURRENT_STEPS + 1}_positions")
        else:
            # capacity E / k: every token of a group fits every expert
            lifted = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k * (1 + 1e-6))
            ref = DecodeEngine(lifted, max_batch=MODEL_BATCH,
                               prompt_len=prompt_len, max_gen=MAX_GEN,
                               dtype=torch.float32, engine=engine,
                               params=eng.params)
            lat, lcaches = ref.prefill(batch)
            ltok = torch.argmax(lat[:, -1], dim=-1)[:, None]
            # the served engine's step on the lifted prefill's caches: a
            # decode step's groups of MODEL_BATCH tokens never overflow
            # the capacity floor of 4, so it drops nothing either
            step, _ = eng.decode_step(ltok, lcaches, prompt_len)
            del lcaches, lat
            # forward over the prompt plus that token: its last position
            want, _ = ref.prefill(dict(batch, tokens=torch.cat(
                [batch["tokens"], ltok.to(batch["tokens"].dtype)], dim=1)))
            # the profiled step below is the first one on eng's caches
            at = prompt_len
            against = "forward_over_prompt_plus_token_capacity_lifted"
        if check != "recurrent":
            step_err = (step - want).abs().max().item()
            within = torch.allclose(step, want, rtol=STEP_RTOL,
                                    atol=STEP_ATOL)
        if not within:
            failures.append(f"model {cfg.name}/{engine}: decode step "
                            f"differs from the {against} by {step_err}")
        if teacher_steps:
            # on a prefill of its own: its last logits and teacher_steps
            # teacher-forced steps against forward over the prompt and
            # those tokens, the batch's other inputs (an encoder's frames)
            # the same
            t_logits, t_caches = eng.prefill(batch)
            teacher_err, t_within, _ = _teacher_forced(
                torch, eng, batch, teacher_steps, t_logits, t_caches)
            del t_logits, t_caches
            if not t_within:
                failures.append(
                    f"model {cfg.name}/{engine}: prefill and "
                    f"{teacher_steps} teacher-forced steps differ from "
                    f"forward over the prompt plus those tokens by "
                    f"{teacher_err}")

        # where a decode step's time goes: one more step under
        # torch.profiler, device time summed by kernel
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.decode_step(tok, caches, at)
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
        print(json.dumps({"phase": "model_profile", "model": cfg.name,
                          "engine": engine,
                          "profiled_step_ms": profiled_ms,
                          "device_ms": device_ms, "kernels": len(spans),
                          "top_kernels_ms": [[n[:90], t / 1e3]
                                             for n, t in top]}), flush=True)
        measured = device_ms > 0
        line = {
            "phase": "model", "model": cfg.name, "engine": engine,
            "flash_decode_engine": fd_engine,
            "layers": cfg.n_layers, "batch": MODEL_BATCH,
            "prompt_len": prompt_len, "max_gen": MAX_GEN,
            "init_s": init_s, "weights_gb": mem_gb,
            "prefill_ms": prefill_ms, "per_step_ms": per_step_ms,
            "untraced_per_step_ms": untraced_step_ms,
            "step_bytes": step_bytes, "step_bound_ms": step_bound_ms,
            "step_bound_share": step_bound_ms / per_step_ms,
            "all_weights_bytes": weights_bytes,
            "all_weights_bound_ms": weights_ms,
            "device_busy_share": (device_ms / profiled_ms if measured
                                  else "not measured"),
            "device_ms_over_untraced_step": (
                device_ms / untraced_step_ms if measured else
                "not measured"),
            "attention_ms_per_step": attn_ms if measured else "not measured",
            "attention_share_of_step": (attn_ms / per_step_ms if measured
                                        else "not measured"),
            "flash_decode_launches": launches[f"attention_{engine}"],
            "decode_step_max_abs_err": step_err,
            "decode_step_against": against,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card": card,
        }
        if teacher_steps:
            line["teacher_forced_max_abs_err"] = teacher_err
            line["teacher_forced_against"] = (
                f"forward_over_prompt_plus_{teacher_steps}_tokens_at_each_"
                f"of_{teacher_steps + 1}_positions")
        if reduced is not None:
            line["reduced"] = reduced
        if cfg.n_experts:
            moe_ms = _moe_device_ms(torch, eng, cfg)
            line["moe_device_ms_per_step"] = moe_ms
            line["moe_share_of_device"] = (moe_ms / device_ms if measured
                                           else "not measured")
        print(json.dumps(line), flush=True)
        del ex, eng, ref, batch, logits, caches, step, want, tok, prof, log
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if len(engines) == 2:
        agree = (tokens["vector"] == tokens["matrix"]).float().mean().item()
        print(f"model {cfg.name}: greedy tokens agree between the vector "
              f"and matrix flash-decode engines on {agree:.1%} of "
              f"{tokens['vector'].numel()} positions", flush=True)
    del params
    torch.cuda.empty_cache()
    path = write_serving_json(kernel, records, str(ROOT / "build" /
                                                   "runs_torch"),
                              env=bench_env("cuda", DEFAULT_DISPATCHER.hw.name))
    try:
        results = check_records([load_file(path)])
    except (OSError, ValueError, NotImplementedError) as exc:
        failures.append(f"model records {cfg.name}: {exc}")
        return launches
    by_claim = {}
    for r in results:
        c = by_claim.setdefault(r.claim, {"checked": 0, "violations": 0})
        c["checked"] += 1
        c["violations"] += int(not r.passed)
        if r.claim in ("model_verdict", "trace_reconciliation"):
            print(json.dumps({"claim": r.claim, "model": cfg.name,
                              "engine": r.record.engine,
                              "passed": r.passed, "detail": r.detail}),
                  flush=True)
    print(json.dumps({"model_claims": by_claim, "model": cfg.name}),
          flush=True)
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
    build/runs_torch/tuned.json and the phase's launches per kernel.

    The cache's key (kernel, engine, dtype, hardware, shards) has no
    size or shape, so it holds the winner of the first STREAM point that
    meets it: the 2-D stencil's, and Mistral-NeMo's flash-decode point
    (G = 4).  The later points' searches are printed with
    ``"cached": false``."""
    import numpy as np

    from repro_torch.bench.bench_kernels import stream_points
    from repro_torch.core.timing import time_fn
    from repro_torch.kernels import _ext, registry
    from repro_torch.tuning import TuningCache, env_fingerprint, tune_op

    path = ROOT / "build" / "runs_torch" / "tuned.json"
    cache = TuningCache(fingerprint=env_fingerprint())
    t_phase = time.perf_counter()
    searches, keyed = 0, set()
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
                cached = (name, engine, pt.dtype) not in keyed
                if cached:
                    keyed.add((name, engine, pt.dtype))
                    cache.merge(TuningCache([entry]))
                print(json.dumps({
                    "phase": "tune", "point": label, "engine": engine,
                    "cached": cached,
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
    untuned = {rec.point: rec
               for rs in load_dir(str(ROOT / "build" / "runs_torch"))
               if rs.kind == "bench" for rec in rs.records}
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
            base = untuned.get(rec.point)
            gap = (rec.us_per_call - base.us_per_call
                   if base is not None else None)
            beyond = bool(gap is not None and gap > base.iqr_us)
            slower += int(beyond)
            print(json.dumps({
                "phase": "tuned_sweep", "kernel": rec.kernel,
                "engine": rec.engine, "size": rec.size, "dtype": rec.dtype,
                "shape": list(rec.shape), "tile": dict(rec.tile_params or {}),
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


def _sharded_phase(torch, hw, card, failures):
    """The sweep's STREAM points split SHARD_MESH ways on the card (and
    SHARD_UNEVEN ways, untimed), every combined output held bit for bit
    against the unsharded kernel's, the records written beside phase 6's
    and verified.  Returns the sweep's launches per kernel.
    """
    from repro_torch.bench import bench_kernels
    from repro_torch.bench.common import bench_env, write_json
    from repro_torch.kernels import _ext, registry
    from repro_torch.report import check_records, load_file, violations

    out_dir = ROOT / "build" / "runs_torch"
    # phase 6's unsharded records of the same points
    unsharded = {}
    for op in registry.all_ops():
        try:
            rs = load_file(str(out_dir / f"BENCH_{op.name}.json"))
        except (OSError, ValueError) as exc:
            failures.append(f"sharded: phase 6's records of {op.name}: {exc}")
            continue
        for rec in rs.records:
            unsharded[(rec.kernel, rec.engine, rec.size, rec.dtype,
                       tuple(rec.shape))] = rec
    env = dict(bench_env("cuda", hw.name), mesh_shape=[SHARD_MESH],
               mesh_exec_mode="virtual")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    _ext.reset_launches()
    paths = []
    for op in registry.all_ops():
        recs = bench_kernels.records_for(op, hw=hw, device="cuda",
                                         stream=True, mesh=SHARD_MESH,
                                         check_widths=(SHARD_UNEVEN,))
        paths.append(write_json(op.name, recs, str(out_dir), env=env,
                                mesh=SHARD_MESH))
        del recs
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    sweep_s = time.perf_counter() - t0
    for op in registry.all_ops():
        for engine in ("vector", "matrix"):
            if launches.get(f"{op.name}_{engine}", 0) == 0:
                failures.append(f"{op.name}_{engine}: no launch in the "
                                f"sharded sweep")
    by_claim = {}
    uneven = {"checked": 0, "bit_equal": 0}
    for path in paths:
        try:
            results = check_records([load_file(path)])
        except (OSError, ValueError, NotImplementedError) as exc:
            failures.append(f"sharded records {path}: {exc}")
            continue
        for r in results:
            c = by_claim.setdefault(r.claim, {"checked": 0, "violations": 0})
            c["checked"] += 1
            c["violations"] += int(not r.passed)
        for r in violations(results):
            rec = r.record
            failures.append(f"sharded claim {r.claim} violated by "
                            f"{rec.kernel}/{rec.engine}/{rec.size}/"
                            f"{rec.dtype}: {r.detail}")
        for raw in json.loads(pathlib.Path(path).read_text())["records"]:
            spec, run = raw["shard_spec"], raw["shard_run"]
            base = unsharded.get((raw["kernel"], raw["engine"], raw["size"],
                                  raw["dtype"], tuple(raw["shape"])))
            tag = (f"sharded/{raw['kernel']}/{raw['engine']}/"
                   f"{raw['dtype']}/{raw['shape']}")
            if not run["equal_unsharded"]:
                failures.append(f"{tag}: combined output differs from the "
                                f"unsharded kernel's")
            at = run.get("equal_unsharded_at", {}).get(str(SHARD_UNEVEN))
            uneven["checked"] += 1
            uneven["bit_equal"] += int(bool(at))
            if not at:
                failures.append(f"{tag}: at {SHARD_UNEVEN} shards the "
                                f"output differs from the unsharded "
                                f"kernel's")
            if run["shard_event_us"] is None or \
                    len(run["shard_event_us"]) != spec["num_shards"]:
                failures.append(f"{tag}: no card time per shard")
            print(json.dumps({
                "phase": "sharded", "mesh": SHARD_MESH,
                "kernel": raw["kernel"], "engine": raw["engine"],
                "dtype": raw["dtype"], "size": raw["size"],
                "shape": raw["shape"], "kind": spec["kind"],
                "shards": spec["num_shards"], "halo": spec["halo"],
                "agg_over_total": spec["agg_bytes"] / spec["total_bytes"],
                "equal_unsharded": run["equal_unsharded"],
                f"equal_unsharded_at_{SHARD_UNEVEN}": at,
                "parallel_s": run["parallel_us"] * 1e-6,
                "serial_s": run["serial_us"] * 1e-6,
                "shard_wall_us": run["shard_wall_us"],
                "shard_event_us": run["shard_event_us"],
                "sharded_call_us": raw["us_per_call"],
                "sharded_call_device_us": raw["profiler_device_us"],
                "unsharded_us": base.us_per_call if base else None,
                "unsharded_device_us": (base.profiler_device_us if base
                                        else None),
                "max_err": raw["max_err"], "card": card}), flush=True)
    for claim in ("shard_ceiling", "shard_traffic"):
        if by_claim.get(claim, {}).get("checked", 0) == 0:
            failures.append(f"sharded: no {claim} claim checked")
    print(json.dumps({"sharded_claims": by_claim, "sweep_s": sweep_s,
                      "card": card}), flush=True)

    print(json.dumps({"sharded_uneven": dict(uneven, mesh=SHARD_UNEVEN,
                                             card=card)}), flush=True)
    return launches


def _elastic_phase(torch, card, failures):
    """Elastic sessions under the seeded adversary on the card, the
    checkpoint / restore drill, and the serve CLI's --mesh and
    --slo-route sessions.  Returns the phase's launches per kernel."""
    from repro_torch.bench import compare
    from repro_torch.bench import serve as serve_cli
    from repro_torch.bench.common import bench_env, write_serving_json
    from repro_torch.core.dispatch import DEFAULT_DISPATCHER
    from repro_torch.kernels import _ext
    from repro_torch.report import (check_records, load_dir, load_file,
                                    violations)
    from repro_torch.serving import (BatchPolicy, ChaosInjector,
                                     ElasticSession, SessionConfig,
                                     checkpoint_session)

    out_dir = str(ROOT / "build" / "runs_torch")
    env = dict(bench_env("cuda", DEFAULT_DISPATCHER.hw.name),
               mesh_shape=[ELASTIC_WIDTH], mesh_exec_mode="virtual")
    policy = BatchPolicy(max_batch=SERVE_MAX_BATCH,
                         max_wait_s=SERVE_MAX_WAIT_S)
    injector = ChaosInjector.seeded(SEED, SERVE_DURATION_S,
                                    max_width=ELASTIC_MAX)
    t_phase = time.perf_counter()
    # the earlier phases leave a large heap, whose full collections pause
    # the host 0.2-0.4 s inside a timed batch (phase 7's gc lines); the
    # elastic claim bounds the chaos leg's p99 by the fault-free leg's, so
    # the heap that exists now is frozen out of collection for this phase
    gc.collect()
    gc.freeze()
    gc_pauses = _GcPauses()
    torch.cuda.synchronize()
    _ext.reset_launches()
    engines = {}
    fault_free = {}
    for name, size, rate in (("scale", SERVE_ELEMENTWISE,
                              SERVE_ELEMENTWISE_RPS),
                             ("stencil", ELASTIC_STENCIL, SERVE_OTHER_RPS),
                             ("attention", ELASTIC_ATTENTION,
                              SERVE_OTHER_RPS)):
        cfg = SessionConfig(kernel=name, workload="poisson", engine="auto",
                            rate_rps=rate, duration_s=SERVE_DURATION_S,
                            size=size, seed=SEED, policy=policy,
                            num_shards=ELASTIC_WIDTH)
        gc_pauses.reset()
        t0 = time.perf_counter()
        log, summary, record = ElasticSession(
            cfg, injector=injector, max_shards=ELASTIC_MAX).run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        ev = record["events"]
        fault_free[name] = (cfg, ev["fault_free"]["checksum"])
        engines[name] = record["engine"]
        tag = f"elastic/{name}"
        applied = [e for e in ev["log"] if not e.get("skipped")]
        fails = [e for e in applied if e["kind"] == "fail"]
        resizes = [e for e in applied if e["kind"] == "resize"]
        if not fails or not resizes:
            failures.append(f"{tag}: {len(fails)} failures and "
                            f"{len(resizes)} resizes applied, expected "
                            f"both")
        if not all(e["redispatch_exact"] for e in fails):
            failures.append(f"{tag}: a re-dispatch was not exact")
        if not all(e["reshard_exact"] for e in resizes):
            failures.append(f"{tag}: a resize was not reshard_exact")
        if ev["availability"] < 0.99 or \
                ev["checksum"] != ev["fault_free"]["checksum"]:
            failures.append(f"{tag}: availability {ev['availability']}, "
                            f"checksum {ev['checksum']!r} vs fault-free "
                            f"{ev['fault_free']['checksum']!r}")
        path = write_serving_json(name, [record], out_dir, env=env,
                                  mesh=ELASTIC_WIDTH)
        try:
            results = check_records([load_file(path)])
        except (OSError, ValueError, NotImplementedError) as exc:
            failures.append(f"{tag} records: {exc}")
            results = []
        integrity = [r for r in results if r.claim == "elastic_integrity"]
        if not integrity:
            failures.append(f"{tag}: no elastic_integrity claim checked")
        for r in violations(results):
            failures.append(f"{tag}: claim {r.claim} violated: {r.detail}")
        print(json.dumps({
            "phase": "elastic", "kernel": name, "engine": record["engine"],
            "size": size, "rate_rps": rate, "spec": ev["spec"],
            "offered": log.offered, "completed": log.completed,
            "availability": ev["availability"],
            "failures": ev["failures"], "resizes": ev["resizes"],
            "recovery_ms_total": ev["recovery_ms_total"],
            "log": [{k: e.get(k) for k in
                     ("kind", "at_s", "shard", "width", "from", "to",
                      "reason", "redispatch_exact", "reshard_exact",
                      "recovery_ms", "skipped")} for e in ev["log"]],
            "checksum": ev["checksum"],
            "fault_free_checksum": ev["fault_free"]["checksum"],
            "p99_ms": summary.p99_ms,
            "fault_free_p99_ms": ev["fault_free"]["p99_ms"],
            "elastic_integrity": [r.passed for r in integrity],
            "gc_full_collections": len(gc_pauses.ms),
            "gc_full_max_ms": max(gc_pauses.ms, default=0.0),
            "wall_s": wall_s, "card": card}), flush=True)
        del log, record
        torch.cuda.empty_cache()

    # the checkpoint / restore drill: a session stopped mid-flight,
    # checkpointed, restored into a fresh session and finished lands on
    # the uninterrupted run's checksum
    cfg, want = fault_free["scale"]
    ckpt_dir = ROOT / "build" / "elastic_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    interrupted = ElasticSession(cfg, max_shards=ELASTIC_MAX)
    interrupted.serve(chaos=False, stop_after_batches=ELASTIC_STOP)
    step = checkpoint_session(interrupted, ckpt_dir)
    resumed = ElasticSession.restore(cfg, ckpt_dir, max_shards=ELASTIC_MAX)
    done_before = len(resumed._resume["completed"])
    log = resumed.serve(chaos=False)
    got = resumed.checksum()
    if got != want:
        failures.append(f"elastic restore: checksum {got!r} != the "
                        f"uninterrupted run's {want!r}")
    print(json.dumps({"elastic_restore": {
        "kernel": "scale", "step": step, "completed_before": done_before,
        "completed_after": log.completed, "checksum": got,
        "uninterrupted_checksum": want, "card": card}}), flush=True)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del interrupted, resumed, log

    # the serve CLI: a 4-way sharded sweep, and an SLO-routed overload
    serve_dir = ROOT / "build" / "runs_torch_serve"
    shutil.rmtree(serve_dir, ignore_errors=True)
    common = ["--kernels", "scale", "--out", str(serve_dir)]
    rcs = [serve_cli.main(common + [
        "--size", str(SERVE_ELEMENTWISE),
        "--rate", str(SERVE_ELEMENTWISE_RPS),
        "--duration", str(SERVE_DURATION_S), "--mesh", str(SHARD_MESH)])]
    rcs.append(serve_cli.main(common + [
        "--size", str(ROUTE_SIZE), "--rate", str(ROUTE_RPS),
        "--duration", str(ROUTE_DURATION_S), "--online-tune",
        "--slo-route"]))
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    for name in ("scale", "stencil", "attention"):
        key = f"{name}_{engines.get(name, 'vector')}"
        if launches.get(key, 0) == 0:
            failures.append(f"{key}: no launch in the elastic phase")
    try:
        results = check_records(load_dir(str(serve_dir)))
    except (OSError, ValueError, NotImplementedError) as exc:
        failures.append(f"serve CLI records: {exc}")
        results = []
    for r in violations(results):
        failures.append(f"serve CLI claim {r.claim} violated: {r.detail}")
    gate_rc = compare.main([str(serve_dir), str(serve_dir)])
    online = json.loads((serve_dir / "BENCH_serve_scale_online.json")
                        .read_text())["records"][0]
    widths = sorted({d["width"] for d in
                     online["tuning"]["router"]["decisions"]})
    mesh = json.loads((serve_dir / f"BENCH_serve_scale_mesh{SHARD_MESH}"
                                   ".json").read_text())["records"]
    if rcs != [0, 0] or gate_rc != 0 or max(widths) <= 1 or \
            any(r["num_shards"] != SHARD_MESH for r in mesh):
        failures.append(f"serve CLI: rcs {rcs}, gate rc {gate_rc}, router "
                        f"widths {widths}, mesh sessions "
                        f"{[r['num_shards'] for r in mesh]}")
    print(json.dumps({"elastic_serve_cli": {
        "rcs": rcs, "gate_rc": gate_rc, "claims": len(results),
        "router_widths": widths,
        "router_decisions": len(online["tuning"]["router"]["decisions"]),
        "mesh_sessions": [{k: r[k] for k in
                           ("engine", "num_shards", "p50_ms", "p99_ms",
                            "compute_p50_ms", "completed")}
                          for r in mesh],
        "phase_s": time.perf_counter() - t_phase, "card": card}}),
        flush=True)
    gc_pauses.close()
    gc.unfreeze()
    return launches


def _mesh_phase(torch, hw, card, failures):
    """Phase 11d (module docstring): the measured mesh on one rank group
    of MESH_RANKS.  Returns the phase's launches per kernel, this
    process's and the other ranks' summed."""
    import numpy as np
    from repro_torch.bench import bench_kernels, compare
    from repro_torch.bench import serve as serve_cli
    from repro_torch.bench.common import bench_env, write_json
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import _ext, registry
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.report import (MESH_CLAIMS, check_records, load_dir,
                                    violations, write_report)
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime.elastic import reshard_restore, restore_on
    from repro_torch.sharding import MeshExecutor, ranks, rules

    t_phase = time.perf_counter()
    sharded_dir = ROOT / "build" / "runs_torch"
    out_dir = ROOT / "build" / "runs_torch_mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    mesh_mod.host_device_count(MESH_RANKS)
    t0 = time.perf_counter()
    pool = ranks.pool()
    start_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    _ext.reset_launches()
    pool.launches(reset=True)
    mex = MeshExecutor(MESH_RANKS)
    probe = mex.overlap_probe()
    print(json.dumps({"mesh_probe": dict(probe, card=card)}), flush=True)
    env = dict(bench_env("cuda", hw.name), mesh_shape=[MESH_RANKS],
               mesh_exec_mode="mesh", collective_overlap=probe)
    engines = {}
    for op in registry.all_ops():
        path = sharded_dir / f"BENCH_{op.name}_mesh{SHARD_MESH}.json"
        try:
            payload = json.loads(path.read_text())
        except (OSError, ValueError) as exc:
            failures.append(f"mesh: phase 11b's records of {op.name}: {exc}")
            continue
        pt = next(bench_kernels.stream_points(
            op, np.random.default_rng(bench_kernels.SEED), "cuda"))
        args, kw = pt.args, pt.kwargs
        shape = bench_kernels._shape(args)
        recs = [r for r in payload["records"]
                if (r["size"], r["dtype"], r["shape"]) ==
                (pt.size, pt.dtype, shape)]
        tag = f"mesh/{op.name}/{pt.dtype}/{shape}"
        if len(recs) != 2:
            failures.append(f"{tag}: {len(recs)} records of phase 11b, "
                            f"expected one per engine")
            continue
        engine = engines[op.name] = mex.engine_for(op, *args, **kw)
        unsharded = op.engines[engine](*args, backend="cuda", **kw)
        want = op.reference(*args, **kw).float()
        plan = mex.plan(op, *args, **kw)
        t0 = time.perf_counter()
        field, trace, out = bench_kernels.mesh_exec_field(
            mex, op, plan, args, kw, want, warmup=2, iters=MESH_ITERS)
        measure_s = time.perf_counter() - t0
        equal = bool(torch.equal(out, unsharded))
        if not equal:
            failures.append(f"{tag}: the {MESH_RANKS}-rank output differs "
                            f"from the unsharded kernel's")
        for rec in recs:
            rec["mesh_exec"] = field
            rec["trace"]["mesh"] = trace
        write_json(op.name, recs, str(out_dir), env=env, mesh=MESH_RANKS)
        line = {"phase": "mesh", "kernel": op.name, "engine": engine,
                "dtype": pt.dtype, "size": pt.size, "shape": shape,
                "ranks": plan.spec.num_shards, "kind": plan.spec.kind,
                "halo": plan.spec.halo,
                "wire_bytes": recs[0]["shard_spec"]["wire_bytes"],
                "equal_unsharded": equal, "mesh_exec": field,
                "measure_s": measure_s, "card": card}
        if op.name == "stencil":
            u3 = MeshExecutor(MESH_UNEVEN).run(op, *args, **kw).out
            line[f"equal_unsharded_at_{MESH_UNEVEN}"] = at = bool(
                torch.equal(u3, unsharded))
            if not at:
                failures.append(f"{tag}: at {MESH_UNEVEN} ranks the output "
                                f"differs from the unsharded kernel's")
            del u3
        print(json.dumps(line), flush=True)
        del args, kw, pt, unsharded, want, out
        torch.cuda.empty_cache()

    by_claim = {}
    try:
        results = check_records(load_dir(str(out_dir)))
    except (OSError, ValueError) as exc:
        failures.append(f"mesh records: {exc}")
        results = []
    for r in results:
        c = by_claim.setdefault(r.claim, {"checked": 0, "violations": 0})
        c["checked"] += 1
        c["violations"] += int(not r.passed)
    for r in violations(results):
        failures.append(f"mesh claim {r.claim} violated by "
                        f"{r.record.kernel}/{r.record.engine}: {r.detail}")
    for claim in MESH_CLAIMS:
        if by_claim.get(claim, {}).get("checked", 0) == 0:
            failures.append(f"mesh: no {claim} claim checked")
    gate_rc = compare.main([str(out_dir), str(out_dir)])
    write_report(str(out_dir), str(out_dir / "REPORT.md"),
                 str(out_dir / "docs" / "benchmarks"))
    rendered = "### Measured collectives" in \
        (out_dir / "REPORT.md").read_text()
    if gate_rc != 0 or not rendered:
        failures.append(f"mesh: gate rc {gate_rc}, measured collectives "
                        f"rendered {rendered}")
    print(json.dumps({"mesh_claims": by_claim, "gate_rc": gate_rc,
                      "collectives_rendered": rendered, "card": card}),
          flush=True)

    # serve --mesh 4 --real: every batch charged the measured mesh wall
    serve_dir = ROOT / "build" / "runs_torch_mesh_serve"
    shutil.rmtree(serve_dir, ignore_errors=True)
    t0 = time.perf_counter()
    rc = serve_cli.main([
        "--kernels", "scale", "--size", str(SERVE_ELEMENTWISE),
        "--rate", str(SERVE_ELEMENTWISE_RPS),
        "--duration", str(SERVE_DURATION_S), "--mesh", str(MESH_RANKS),
        "--real", "--out", str(serve_dir)])
    serve_s = time.perf_counter() - t0
    sessions = []
    try:
        rs_path = serve_dir / f"BENCH_serve_scale_mesh{MESH_RANKS}.json"
        sessions = json.loads(rs_path.read_text())["records"]
        served = check_records(load_dir(str(serve_dir)))
    except (OSError, ValueError) as exc:
        failures.append(f"mesh serve records: {exc}")
        served = []
    serve_gate = compare.main([str(serve_dir), str(serve_dir)])
    if rc != 0 or serve_gate != 0 or violations(served) or not sessions \
            or any(r["mesh_exec_mode"] != "mesh" or r["completed"] == 0
                   for r in sessions):
        failures.append(f"mesh serve: rc {rc}, gate rc {serve_gate}, "
                        f"{len(violations(served))} violations, sessions "
                        f"{[(r['mesh_exec_mode'], r['completed']) for r in sessions]}")
    print(json.dumps({"mesh_serve": {
        "rc": rc, "gate_rc": serve_gate, "claims": len(served),
        "sessions": [{k: r[k] for k in
                      ("engine", "num_shards", "mesh_exec_mode", "p50_ms",
                       "p99_ms", "compute_p50_ms", "completed")}
                     for r in sessions],
        "wall_s": serve_s, "card": card}}), flush=True)

    # the trainer: 2 x 2 ranks against 1 x 1 on one seed, then the 2 x 2
    # checkpoint restored onto 1 x 2 ranks
    cfg = reduced(get_arch(MESH_TRAIN_ARCH))
    ck = {m: ROOT / "build" / f"mesh_train_{m}" for m in ("1x1", "2x2")}
    for d in ck.values():
        shutil.rmtree(d, ignore_errors=True)
    common = ["--arch", MESH_TRAIN_ARCH, "--reduced", "--steps",
              str(MESH_TRAIN_STEPS)]
    times, metrics = {}, {}
    for m, extra in (("1x1", []), ("2x2", ["--mesh", "2x2", "--devices",
                                            str(MESH_RANKS)])):
        t0 = time.perf_counter()
        metrics[m] = train.main(common + extra + ["--ckpt-dir", str(ck[m])])
        times[m] = time.perf_counter() - t0
    loss1, loss2 = float(metrics["1x1"]["loss"]), float(metrics["2x2"]["loss"])
    template = lm.init_params(cfg, seed=1, device="cuda")
    p1 = ckpt.restore(ck["1x1"], (template, None),
                      step=MESH_TRAIN_STEPS)[0]
    p2 = ckpt.restore(ck["2x2"], (template, None),
                      step=MESH_TRAIN_STEPS)[0]
    param_gap = max(float((a - b).abs().max())
                    for a, b in zip(p1.parameters(), p2.parameters()))
    loss_ok = abs(loss2 - loss1) <= 1e-5 * abs(loss1)
    if not loss_ok or not param_gap < 5e-4:
        failures.append(f"mesh train: 2x2 loss {loss2} vs 1x1 {loss1}, "
                        f"parameter gap {param_gap}")
    print(json.dumps({"mesh_train": {
        "arch": cfg.name, "steps": MESH_TRAIN_STEPS, "loss_1x1": loss1,
        "loss_2x2": loss2, "losses_2x2": metrics["2x2"]["losses"],
        "param_gap": param_gap, "wall_s": times, "card": card}}),
        flush=True)
    m12 = mesh_mod.make_test_mesh((1, 2))
    (whole, _), step = reshard_restore(str(ck["2x2"]), (template, None),
                                       m12)
    parts = restore_on(m12, str(ck["2x2"]), cfg, train_state=True)
    shardings = rules.to_shardings(m12, rules.param_pspecs(template, m12))
    split = exact = 0
    for name, t in whole.named_parameters():
        sh = shardings[name]
        rebuilt = torch.zeros_like(t)
        for r, part in enumerate(parts):
            rebuilt[sh.index(r, tuple(t.shape))] = part[name]
        split += bool(sh.split_dims(t.ndim))
        exact += bool(torch.equal(rebuilt, t)
                      and torch.equal(t, dict(p2.named_parameters())[name]))
    leaves = len(shardings)
    if exact != leaves or step != MESH_TRAIN_STEPS or split == 0:
        failures.append(f"mesh restore: {exact} of {leaves} leaves exact, "
                        f"step {step}, {split} split")
    print(json.dumps({"mesh_restore": {
        "from": "2x2", "to": "1x2", "step": step, "leaves": leaves,
        "split_leaves": split, "exact": exact, "card": card}}), flush=True)
    del whole, parts, template, p1, p2

    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    for name, n in pool.launches().items():
        launches[name] = launches.get(name, 0) + n
    for name, engine in engines.items():
        if launches.get(f"{name}_{engine}", 0) == 0:
            failures.append(f"{name}_{engine}: no launch in the mesh phase")
    ranks.close_pool()
    mesh_mod.host_device_count(1)
    for d in ck.values():
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps({"mesh_phase": {
        "pool_start_s": start_s, "engines": engines,
        "launches": {k: v for k, v in sorted(launches.items()) if v},
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
    b, kh, g, dh = q.shape
    return (f"attention/{pt.dtype}/B{b}xS{k.shape[1]}xKH{kh}xG{g}"
            + ("" if dh == 128 else f"xDh{dh}"), tuple(k.shape))


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
                    "shape": list(rec.shape),
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


def _ffma_floor(torch, ffma, device_us):
    """The vector kernel's FFMA floor: ``ffma`` multiply-adds at 128 per
    SM and clock, at the card's maximum SM clock, with the SM clock read
    now (nvidia-smi) and the FFMA share of the measured device time."""
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    now_mhz, max_mhz = (float(x) for x in
                        smi.stdout.strip().splitlines()[0].split(","))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * 128 * max_mhz * 1e6          # FFMA per second
    out = {"ffma": ffma, "ffma_floor_ms": ffma / rate * 1e3,
           "sm_clock_mhz": now_mhz, "sm_clock_max_mhz": max_mhz}
    if device_us != "not measured":
        out["ffma_share_of_device_time"] = ffma / rate / (device_us * 1e-6)
    return out


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


def _library_fn(torch, F, name, args, kw):
    """One PyTorch call computing the same function, as a closure to time:
    a yardstick only, which the port never calls."""
    if name == "scale":
        b, q = args
        return lambda: torch.mul(b, q)
    if name == "triad":
        b, c, q = args
        return lambda: torch.add(b, c, alpha=q)
    if name == "axpy":
        a, x, y = args
        return lambda: torch.add(y, x, alpha=a)
    if name == "spmv":
        bell, x = args
        # torch.sparse_bsr_tensor is not used: its matvec refuses the
        # 8x128 blocks.  A CSR tensor of the same matrix (built here,
        # outside the timed call) goes to cuSPARSE's SpMV.
        csr = bell.todense().to_sparse_csr()
        return lambda: torch.mv(csr, x)
    if name == "attention":
        q, k, v, kv_len = args
        b, kh, g, dh = q.shape
        # SDPA's layout, and only the kv_len valid positions (7/8 of the
        # cache), arranged outside the timed call
        qs = q.reshape(b, kh * g, 1, dh)
        ks = k[:, :kv_len].permute(0, 2, 1, 3).contiguous()
        vs = v[:, :kv_len].permute(0, 2, 1, 3).contiguous()
        major, minor = (int(x) for x in torch.__version__.split(".")[:2])
        if (major, minor) >= (2, 5):
            return lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                          enable_gqa=True)
        ks = ks.repeat_interleave(g, dim=1)
        vs = vs.repeat_interleave(g, dim=1)
        return lambda: F.scaled_dot_product_attention(qs, ks, vs)
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
    return run


if __name__ == "__main__":
    sys.exit(main())
