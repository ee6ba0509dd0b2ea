"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

LM inference under traffic: seeded requests from the serving subsystem's
load generators are queued, continuously batched, and decoded against a
KV cache (``repro_torch.serving.lm.LMDecodeExecutor``), every GQA
layer's attention through the flash-decode kernel (MLA layers in the
absorbed latent form), with the advisor's
memory-bound analysis of the decode step logged up front (the paper's §6
technique applied to LM inference) and the session's latency
percentiles (queue/compute split), goodput and SLO attainment printed at
the end.

``--reduced`` (default) serves the smoke-size config; ``--no-reduced``
serves the full-size architecture.  Runs on the card; ``--device cpu``
runs the kernels' plain versions on the CPU.  Every architecture runs:
dense, MoE and MLA (``--arch deepseek-v2-lite-16b``), SSM and hybrid
(``--arch zamba2-7b``), the encoder-decoder (``--arch
seamless-m4t-large-v2``: each prompt's audio frames through the encoder,
cross-attention on the cached encoder K / V) and the vision frontend
with M-RoPE (``--arch qwen2-vl-72b``).
"""
import argparse
import time

import torch

from ..configs import ARCHS, get_arch, reduced
from ..core.dispatch import DEFAULT_DISPATCHER
from ..models.advisor_map import model_verdict
from ..obs.log import LOG
from ..serving import (BatchPolicy, LMDecodeExecutor, SLO, SessionConfig,
                       format_summary, run_session)
from ..serving.lm import decode_traits
from ..serving.requests import LM_DECODE
from ..serving.session import BACKEND_FOR_DEVICE


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the smoke-size config (--no-reduced for "
                         "the full architecture)")
    ap.add_argument("--batch", type=int, default=4,
                    help="continuous-batching capacity (max batch)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens generated per request")
    ap.add_argument("--workload", default="poisson",
                    choices=("poisson", "bursty", "closed"))
    ap.add_argument("--rate", type=float, default=16.0,
                    help="offered rate knob, requests/s")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="session horizon, virtual seconds")
    ap.add_argument("--slo-ms", type=float, default=1000.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default), or the CPU with the "
                         "kernels' plain versions")
    args = ap.parse_args(argv)
    LOG.configure(level="info")   # launcher mains narrate by default
    # IEEE float32 everywhere: no TF32 in the matmuls
    torch.backends.cuda.matmul.allow_tf32 = False

    full = get_arch(args.arch)
    cfg = reduced(full) if args.reduced else full

    # dispatch layer: the production-size decode step is memory-bound
    traits = decode_traits(full, 128, 32768)
    LOG.info("advisor", arch=full.name,
             advice=DEFAULT_DISPATCHER.advise_traits(traits))

    # the model-scale verdict: what fraction of a full-size decode step
    # the Eq. 23/24 memory-bound ceiling governs, op by op
    v = model_verdict(full, args.batch, args.prompt_len + args.gen)
    LOG.info("model verdict", model=v.model,
             memory_bound_time_frac=f"{v.memory_bound_time_frac:.1%}",
             memory_bound_bytes_frac=f"{v.memory_bound_bytes_frac:.1%}",
             memory_bound_ops=sum(1 for o in v.ops if o.memory_bound),
             ops=len(v.ops))

    executor = LMDecodeExecutor(cfg, max_batch=args.batch,
                                prompt_len=args.prompt_len,
                                max_gen=args.gen, dtype=torch.float32,
                                seed=args.seed, verdict_cfg=full,
                                device=args.device)
    session = SessionConfig(
        kernel=LM_DECODE, workload=args.workload, rate_rps=args.rate,
        duration_s=args.duration, size=args.gen, seed=args.seed,
        policy=BatchPolicy(max_batch=args.batch, max_wait_s=0.05),
        slo=SLO(latency_ms=args.slo_ms), device=args.device,
        backend=BACKEND_FOR_DEVICE[args.device])
    t0 = time.perf_counter()
    _, summary, _ = run_session(session, executor)
    wall = time.perf_counter() - t0
    for line in format_summary(summary):
        print(line)
    print(f"(wall time {wall:.2f}s)")


if __name__ == "__main__":
    main()
