"""End-to-end training on the port: a ~100M-param LM through the full
stack -- data pipeline, AdamW, checkpoint / restart, straggler watchdog.

Presets:
  tiny  (~12M, quick CI-style run)        python examples_torch/train_lm.py
  100m  (~115M, a few hundred steps)      python examples_torch/train_lm.py \
                                            --preset 100m --steps 300

Crash / restart drill: add ``--fail-at 120`` then run the same command
again; the loop resumes from the last checkpoint (every ``--ckpt-every``
steps) and ends where an uninterrupted run ends.  ``--device cpu`` trains
on the CPU.

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime.train_loop import (FailureInjector,
                                            StragglerWatchdog,
                                            TrainLoopConfig, run)

PRESETS = {
    "tiny": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                 head_dim=64, d_ff=1024, vocab=8192),
    "100m": dict(n_layers=8, d_model=768, n_heads=12, n_kv_heads=12,
                 head_dim=64, d_ff=3072, vocab=32000),
}


def main(argv=None):
    """Train; returns (params, opt_state, the last step's metrics)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--arch", default="deepseek-7b",
                    help="family donor (any assigned arch id)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="ckpts/train_lm")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_arch(args.arch), **PRESETS[args.preset],
                              name=f"{args.arch}-{args.preset}")
    n = cfg.param_count()
    print(f"model: {cfg.name}  params={n/1e6:.1f}M  "
          f"tokens/step={args.batch * args.seq}")

    opt = AdamW(lr=cosine_schedule(3e-4, warmup=20, total=args.steps),
                weight_decay=0.1, clip_norm=1.0)
    pipe = TokenPipeline(cfg, global_batch=args.batch, seq=args.seq,
                         device=args.device)
    step_fn = make_train_step(cfg, opt, dtype=torch.float32)

    def init_state():
        params = lm.init_params(cfg, seed=0, device=args.device)
        return params, opt.init(params)

    loop = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                           ckpt_dir=args.ckpt_dir, log_every=10)
    injector = FailureInjector(args.fail_at) if args.fail_at else None
    out = run(loop, init_state=init_state, step_fn=step_fn,
              batch_fn=pipe.batch, watchdog=StragglerWatchdog(),
              injector=injector)
    if "loss" in out[2]:
        print(f"final loss: {float(out[2]['loss']):.4f}")
    return out


if __name__ == "__main__":
    main()
