"""LM serving under traffic on the port: seeded Poisson requests,
continuous batching and a latency-percentile table -- the memory-bound
regime the paper's advisor reasons about, measured as a request stream
instead of a lone decode loop.

Each decode step's attention is a GEMV against the KV cache: the advisor
classifies it (memory-bound -> vector engine; the tensor cores could buy
at most 1+I/B), and on the card every GQA layer runs it through the
flash-decode kernel (K4) inside ``LMDecodeExecutor``.  ``--engine``
forces that kernel's engine; ``--device cpu`` runs its plain version.

Run:  PYTHONPATH=src python examples_torch/serve_lm.py [--arch mamba2-780m]
"""
import argparse

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import EngineAdvisor, H100_SXM, spec_for_device_name
from repro_torch.serving import (BatchPolicy, LMDecodeExecutor, SLO,
                                 SessionConfig, format_summary, run_session)
from repro_torch.serving.lm import decode_traits
from repro_torch.serving.requests import LM_DECODE


def card_spec(device: str):
    """The HardwareSpec of the card (H100 SXM5 for ``--device cpu``)."""
    if device == "cuda":
        return spec_for_device_name(torch.cuda.get_device_name(0))
    return H100_SXM


def main(argv=None):
    """Serve the stream; returns the session's summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--rate", type=float, default=16.0,
                    help="offered Poisson rate, requests/s")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="session horizon, virtual seconds")
    ap.add_argument("--slo-ms", type=float, default=1000.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "vector", "matrix"),
                    help="the flash-decode kernel's engine")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = reduced(get_arch(args.arch))

    # --- advisor analysis of the decode regime (full-size config) ---
    full = get_arch(args.arch)
    advice = EngineAdvisor(card_spec(args.device)).advise(
        decode_traits(full, 64, 32768))
    print(f"[advisor] {advice}")

    # --- serve a seeded request stream through continuous batching ---
    executor = LMDecodeExecutor(cfg, max_batch=args.batch,
                                prompt_len=args.prompt_len,
                                max_gen=args.gen, dtype=torch.float32,
                                seed=args.seed, engine=args.engine,
                                device=args.device)
    session = SessionConfig(
        kernel=LM_DECODE, workload="poisson", rate_rps=args.rate,
        duration_s=args.duration, size=args.gen, seed=args.seed,
        policy=BatchPolicy(max_batch=args.batch, max_wait_s=0.05),
        slo=SLO(latency_ms=args.slo_ms))
    _, summary, _ = run_session(session, executor)
    print(f"({args.gen} tokens per request)")
    for line in format_summary(summary):
        print(line)
    return summary


if __name__ == "__main__":
    main()
