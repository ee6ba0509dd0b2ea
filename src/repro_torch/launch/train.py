"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains on the card (``--device cpu`` for the CPU): seeded random float32
weights, the deterministic ``TokenPipeline``, AdamW on a cosine schedule
and the restart-oriented loop of ``runtime.train_loop`` (atomic
checkpoints under ``--ckpt-dir``; a rerun resumes from the newest).  The
dispatcher's advice on the train step's traits is logged first: ~6 P
flops a token against ~16 P bytes of parameters, gradients and optimizer
state, compute-bound at any real batch, the mirror image of the decode
step ``serve`` classifies.

``--mesh DxM --devices N`` (D x M = N) trains on N ranks of a
``data x model`` mesh (``launch.mesh``, ``sharding.ranks``): each rank
stores its slice of every leaf (parameters and AdamW's moments) by
``sharding.rules.param_pspecs``, gathers the leaves over the model axis
for the step, takes its rows of the global batch on the data axis, and
all-reduces the gradients over it (their mean: the global batch's
gradient for a loss that is a mean over equal shards, the dense
families'); the clip's global norm is taken on the whole gradients, and
each rank updates its own slices.  Rank 0 writes the checkpoints, whole
leaves in the reference's format, and a rerun resumes through
``runtime.elastic.reshard_restore`` onto any mesh.  On one card the N
ranks share its memory, so a mesh above ``1x1`` is for ``--reduced``
configs; the full-width step is the ``1x1`` one.
"""
import argparse
import dataclasses
import time

import torch

from ..configs import ARCHS, get_arch, reduced
from ..core.dispatch import DEFAULT_DISPATCHER
from ..core.intensity import KernelTraits
from ..data.pipeline import TokenPipeline
from ..models import lm
from ..models.engine import resolve_device
from ..obs.log import LOG
from ..optim.adamw import AdamW, cosine_schedule, global_norm
from ..optim.compression import compress_in_place
from ..runtime import checkpoint as ckpt
from ..runtime.train_loop import StragglerWatchdog, TrainLoopConfig, run
from . import steps as steps_mod


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model, e.g. 2x2 (requires --devices 4); "
                         "the ranks share one card, so above 1x1 train a "
                         "--reduced config")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks to start: data x model of --mesh")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compress", default=None,
                    choices=(None, "bf16", "int8"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default), or the CPU")
    args = ap.parse_args(argv)
    try:
        args.mesh_shape = tuple(int(x) for x in args.mesh.split("x"))
        assert len(args.mesh_shape) == 2 and min(args.mesh_shape) >= 1
    except (ValueError, AssertionError):
        ap.error(f"--mesh must be DxM, got {args.mesh!r}")
    n = args.mesh_shape[0] * args.mesh_shape[1]
    if args.devices is None and n > 1:
        ap.error(f"--mesh {args.mesh} needs --devices {n}")
    if args.devices is not None and args.devices != n:
        ap.error(f"--mesh {args.mesh} is {n} ranks, not --devices "
                 f"{args.devices}")
    if args.batch % args.mesh_shape[0]:
        ap.error(f"--batch {args.batch} does not split over the data axis "
                 f"of {args.mesh}")
    return args


def main(argv=None):
    args = _parse(argv)
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
    ckpt_dir = args.ckpt_dir or f"ckpts/{cfg.name}"
    if args.devices is not None and args.devices > 1:
        metrics = _train_mesh(args, cfg, device.type, ckpt_dir)
    else:
        metrics = _train_one(args, cfg, device, ckpt_dir)
    if "loss" in metrics:
        print(f"done: loss={float(metrics['loss']):.4f}")
    else:
        print(f"done: no step to run, {ckpt_dir} is at step {args.steps}")
    return metrics


def _train_one(args, cfg, device, ckpt_dir):
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
        ckpt_dir=ckpt_dir, log_every=max(args.steps // 10, 1))
    _, _, metrics = run(loop, init_state=init_state, step_fn=step,
                        batch_fn=pipe.batch, watchdog=StragglerWatchdog())
    return metrics


# --------------------------------------------------------------------------
# the data x model mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Job:
    """One mesh training run, as every rank receives it."""

    cfg: object
    mesh_shape: tuple
    steps: int
    batch: int
    seq: int
    lr: float
    grad_compress: object
    device: str
    ckpt_dir: str


def _train_mesh(args, cfg, device: str, ckpt_dir: str):
    from . import mesh as mesh_mod
    mesh_mod.host_device_count(max(args.devices, mesh_mod.host_ranks()))
    mesh = mesh_mod.make_auto_mesh(args.mesh_shape, ("data", "model"))
    job = _Job(cfg, args.mesh_shape, args.steps, args.batch, args.seq,
               args.lr, args.grad_compress, device, ckpt_dir)
    answers = mesh.live().call(mesh.size, _train_rank,
                               [(job,)] * mesh.size)
    return answers[0]


def _leaf_groups(ctx, mesh, shardings):
    """Per sharded leaf, the gloo group of the ranks holding its slices
    (every rank asks for every group in the same order)."""
    groups = {}
    for name, sh in shardings.items():
        peers = sh.peers(ctx.rank)
        if len(peers) > 1 and peers not in groups:
            groups[peers] = ctx.subgroup(peers)
    return groups


def _gather(ctx, groups, shardings, local, cfg, shapes):
    """The whole LM from this rank's slices."""
    return lm.LM(cfg, {
        n: (shardings[n].gather(groups[shardings[n].peers(ctx.rank)], t,
                                shapes[n])
            if len(shardings[n].peers(ctx.rank)) > 1 else t)
        for n, t in local.named_parameters()})


def _train_rank(ctx, job: _Job):
    """One rank of a mesh training run (module docstring)."""
    from ..runtime.elastic import local_slices, reshard_restore
    from ..sharding import rules
    from .mesh import make_auto_mesh
    cfg = job.cfg
    device = torch.device("cuda", 0) if job.device == "cuda" else \
        torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_auto_mesh(job.mesh_shape, ("data", "model"))
    d, _ = mesh.coords(ctx.rank)
    dp = job.mesh_shape[0]
    data_group = ctx.subgroup(tuple(
        r for r in range(mesh.size)
        if mesh.coords(r)[1] == mesh.coords(ctx.rank)[1]))
    opt = AdamW(lr=cosine_schedule(job.lr, 10, job.steps))
    local_opt = dataclasses.replace(opt, clip_norm=None)
    full = lm.init_params(cfg, seed=0, device=device)
    shapes = {n: tuple(t.shape) for n, t in full.named_parameters()}
    shardings = rules.to_shardings(mesh, rules.param_pspecs(full, mesh))
    groups = _leaf_groups(ctx, mesh, shardings)
    template = (full, opt.init(full))
    start = ckpt.latest_step(job.ckpt_dir) or 0
    if start:
        (params, state), _ = reshard_restore(job.ckpt_dir, template, mesh,
                                             step=start, rank=ctx.rank)
    else:
        params = local_slices(full, shardings, ctx.rank)
        state = local_slices(template[1], type(template[1])(
            rules.Sharding(mesh, ()), shardings, shardings, None),
            ctx.rank)
    del full, template
    value_and_grad = steps_mod.make_value_and_grad(cfg, dtype=torch.float32)
    pipe = TokenPipeline(cfg, global_batch=job.batch, seq=job.seq,
                         device=device)
    rows = slice(d * job.batch // dp, (d + 1) * job.batch // dp)
    losses = []
    for step in range(start, job.steps):
        t0 = time.perf_counter()
        whole = _gather(ctx, groups, shardings, params, cfg, shapes)
        batch = {k: v[rows] for k, v in pipe.batch(step).items()}
        (_, metrics), grads = value_and_grad(whole, batch)
        if job.grad_compress:
            compress_in_place(grads, job.grad_compress)
        named = [t for _, t in sorted(grads.named_parameters())]
        flat = torch.cat([t.reshape(-1) for t in named]
                         + [metrics["loss"].reshape(1).float()])
        flat = data_group.all_reduce(flat) / dp
        off = 0
        with torch.no_grad():
            for t in named:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
            loss = flat[off]
            # the clip's norm over the whole gradients, as one device's
            if opt.clip_norm is not None:
                scale = torch.clamp_max(
                    opt.clip_norm / (global_norm(grads) + 1e-9), 1.0)
                for t in named:
                    t.mul_(scale)
        params, state = local_opt.update(
            local_slices(grads, shardings, ctx.rank), state, params)
        losses.append(float(loss))
        if ctx.rank == 0:
            LOG.info("mesh_step", step=step + 1, loss=losses[-1],
                     ms=(time.perf_counter() - t0) * 1e3)
        del whole, grads, flat
    # rank 0 writes the whole leaves: the checkpoint any mesh restores
    whole = _gather(ctx, groups, shardings, params, cfg, shapes)
    moments = [_gather(ctx, groups, shardings, tree, cfg, shapes)
               for tree in (state.m, state.v)]
    if ctx.rank == 0:
        ckpt.save(job.ckpt_dir, job.steps,
                  (whole, type(state)(state.count, *moments, None)))
    return {"loss": losses[-1], "losses": losses} if losses else \
        {"losses": losses}


if __name__ == "__main__":
    main()
