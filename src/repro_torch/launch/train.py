"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains on the card (``--device cpu`` for the CPU): seeded random float32
weights, the deterministic ``TokenPipeline``, AdamW on a cosine schedule
and the restart-oriented loop of ``runtime.train_loop`` (atomic
checkpoints under ``--ckpt-dir``; a rerun resumes from the newest).  The
dispatcher's advice on the train step's traits is logged first: ~6 P
flops a token against ~16 P bytes of parameters, gradients and optimizer
state, compute-bound at any real batch, the mirror image of the decode
step ``serve`` classifies.

One device: ``--mesh`` other than ``1x1`` and ``--devices`` wait for the
measured mesh (ROADMAP.md Queue 1 item 13.3).
"""
import argparse

import torch

from ..configs import ARCHS, get_arch, reduced
from ..core.dispatch import DEFAULT_DISPATCHER
from ..core.intensity import KernelTraits
from ..data.pipeline import TokenPipeline
from ..models import lm
from ..models.engine import resolve_device
from ..obs.log import LOG
from ..optim.adamw import AdamW, cosine_schedule
from ..runtime.train_loop import StragglerWatchdog, TrainLoopConfig, run
from ..serving.batcher import MESH_WAITS
from . import steps as steps_mod

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model; only 1x1 (one device) runs")
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compress", default=None,
                    choices=(None, "bf16", "int8"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default), or the CPU")
    args = ap.parse_args(argv)
    if args.mesh != "1x1" or args.devices is not None:
        raise NotImplementedError(f"--mesh {args.mesh} / --devices "
                                  f"{args.devices}: {MESH_WAITS}")
    LOG.configure(level="info")   # launcher mains narrate by default
    # IEEE float32 everywhere: no TF32 in the matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tokens = args.batch * args.seq
    traits = KernelTraits(f"train_step@{cfg.name}",
                          6.0 * cfg.param_count() * tokens,
                          16.0 * cfg.param_count())
    LOG.info("advisor", arch=cfg.name,
             advice=DEFAULT_DISPATCHER.advise_traits(traits))

    opt = AdamW(lr=cosine_schedule(args.lr, 10, args.steps))
    pipe = TokenPipeline(cfg, global_batch=args.batch, seq=args.seq,
                         device=device)
    step = steps_mod.make_train_step(cfg, opt, dtype=torch.float32,
                                     grad_compress=args.grad_compress)

    def init_state():
        params = lm.init_params(cfg, seed=0, device=device)
        return params, opt.init(params)

    loop = TrainLoopConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 2, 1),
        ckpt_dir=args.ckpt_dir or f"ckpts/{cfg.name}",
        log_every=max(args.steps // 10, 1))
    _, _, metrics = run(loop, init_state=init_state, step_fn=step,
                        batch_fn=pipe.batch, watchdog=StragglerWatchdog())
    if "loss" in metrics:
        print(f"done: loss={float(metrics['loss']):.4f}")
    else:
        print(f"done: no step to run, {loop.ckpt_dir} is at step "
              f"{args.steps}")


if __name__ == "__main__":
    main()
