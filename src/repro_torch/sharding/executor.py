"""Sharded execution of registry kernels via the dispatch layer.

The runtime half of :mod:`repro_torch.sharding.plan`: a
:class:`ShardedExecutor` takes an op + call arguments, plans the split
(:func:`~repro_torch.sharding.plan.plan_for`), and launches each shard
through ``repro_torch.core.dispatch.DEFAULT_DISPATCHER``, so every
per-shard launch gets the §6 engine decision and the per-(kernel, engine,
dtype, hw, shard shape) tuned tile config, exactly as an unsharded call
would.  Outputs are reassembled with
:func:`~repro_torch.sharding.plan.combine_outputs` and equal the unsharded
result bit for bit (halo rows carry the trapezoid dependency of Eq. 13;
data/head splits are independent; a head shard runs the unsharded call's
split-S schedule).

Timing model: the shards are launched one after another on the
executor's one device, each shard's time is the host wall time between
two synchronizations (``torch.cuda.synchronize`` on the card), and
:class:`ShardRun` reports both the serial sum and the ``parallel_s``
maximum: what an N-device mesh would charge the virtual serving clock
when the shards run side by side.  Per-shard *correctness* is real,
per-shard *time* is measured, and the N-way-parallel number is the
max-reduction the scheduler accounts, not a measured speedup.  A shard's
slice (and its copy, where the kernel needs one) is made before its
clock starts.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.dispatch import DEFAULT_DISPATCHER, Dispatcher
from ..core.timing import time_fn, timing_of
from ..obs.trace import TRACER
from .plan import (ShardPlan, combine_outputs, first_array, plan_for,
                   shard_call)

__all__ = ["MeshExecutor", "MeshRun", "ShardRun", "ShardedExecutor"]


def _sync(backend: str) -> None:
    if backend == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass(frozen=True)
class ShardRun:
    """One sharded execution: the combined output + per-shard times."""

    out: Any
    plan: ShardPlan
    shard_seconds: Tuple[float, ...]

    @property
    def parallel_s(self) -> float:
        """Wall time an N-way mesh is charged: the slowest shard."""
        return max(self.shard_seconds) if self.shard_seconds else 0.0

    @property
    def serial_s(self) -> float:
        """Total measured compute across shards (host wall time)."""
        return float(sum(self.shard_seconds))


class ShardedExecutor:
    """Run registry kernels shard by shard on one device.

    The execution engine behind ``repro_torch.bench kernels --mesh N`` and
    the serving batcher's shard-parallel packing: plans once per call
    shape, launches every shard through the dispatcher (memoized §6 Advice
    + tuned tiles per shard), and reassembles the exact unsharded result.
    ``engine`` follows the dispatch layer's conventions and ``backend``
    is the reference's ``interpret``: ``"cuda"`` launches the hand-written
    kernels, ``"plain"`` their plain versions on the CPU.
    ``num_shards=1`` degrades to one dispatched call wrapped in the same
    timing envelope.
    """

    def __init__(self, num_shards: int, *, engine: str = "auto",
                 backend: str = "cuda", dispatcher=None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        self.engine = engine
        self.backend = backend
        self.dispatcher = (dispatcher if dispatcher is not None
                           else DEFAULT_DISPATCHER)
        self._flat = None  # lazy mesh-1 view of self.dispatcher

    def _shard_dispatcher(self):
        """The dispatcher per-shard launches go through.

        A shard's launch is already the split: advising it under a
        mesh-configured dispatcher would plan a bogus sub-split onto its
        memoized Advice.  When the backing dispatcher has a mesh set,
        shards run through a flat (mesh-1) view sharing its advisor and
        tuning policy, so §6 routing and tuned tiles are identical and
        only the shard-spec planning is skipped.
        """
        if self.dispatcher.mesh_shards == 1:
            return self.dispatcher
        if self._flat is None:
            self._flat = Dispatcher(advisor=self.dispatcher.advisor,
                                    tuning=self.dispatcher.tuning)
        return self._flat

    def plan(self, op, *args, **kwargs) -> ShardPlan:
        """The ShardPlan this executor would use for one call."""
        return plan_for(op, self.num_shards, *args, **kwargs)

    def run(self, op, *args, engine: Optional[str] = None,
            plan: Optional[ShardPlan] = None, **kwargs) -> ShardRun:
        """Plan, launch every shard via dispatch, and reassemble.

        Each shard's launch is a normal ``Dispatcher.run`` (§6 engine
        routing and tuned tile lookup included), timed on its own so
        callers can account the shard-parallel (max) or serial (sum)
        cost.  Pass *plan* to reuse a prior plan across calls of the same
        shape (the serving batcher's steady-state path).
        """
        eng = self.engine if engine is None else engine
        if plan is None:
            plan = self.plan(op, *args, **kwargs)
        dispatcher = self._shard_dispatcher()
        outputs, times = [], []
        with TRACER.span("shard_run", layer="mesh", kernel=op.name,
                         kind=plan.spec.kind, shards=len(plan.shards)):
            for i, shard in enumerate(plan.shards):
                sargs, skw = shard_call(plan, shard, args, kwargs)
                _sync(self.backend)
                t0 = time.perf_counter()
                out = dispatcher.run(op, *sargs, engine=eng,
                                     backend=self.backend, **skw)
                _sync(self.backend)
                dt = time.perf_counter() - t0
                del sargs, skw
                # emitted with the measured times: span == sample
                TRACER.emit("shard", layer="mesh", start_s=t0, dur_s=dt,
                            kernel=op.name, shard=i)
                times.append(dt)
                outputs.append(out)
            template = first_array(args) if plan.spec.kind == "data" \
                else None
            with TRACER.span("reassembly", layer="mesh", kernel=op.name):
                combined = combine_outputs(plan, outputs,
                                           template=template)
        return ShardRun(out=combined, plan=plan,
                        shard_seconds=tuple(times))


# --------------------------------------------------------------------------
# the measured mesh: the shards side by side on N ranks
# --------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _is_split(x: Any) -> bool:
    """A tensor argument the data split cuts (0-d tensors ride along)."""
    return isinstance(x, torch.Tensor) and x.ndim > 0


@dataclasses.dataclass(frozen=True)
class MeshRun:
    """One measured mesh step: the combined output + its wall time.

    Unlike :class:`ShardRun` (shards one after another, the N-way clock
    modelled as their maximum), ``wall_s`` is the measured wall of one
    step on ``devices`` ranks: every rank ran its shard and its exchange,
    and the step ended when the last rank was done.
    """

    out: Any
    plan: ShardPlan
    devices: int
    wall_s: float

    @property
    def parallel_s(self) -> float:
        """The batcher's charge: the measured wall."""
        return self.wall_s


@dataclasses.dataclass(frozen=True)
class _Program:
    """What every rank of one lowered call runs (sent to each rank).

    ``kind`` picks the body (``data`` / ``bell`` / ``stencil`` /
    ``head``); ``statics`` are the call's positional arguments with None
    where a rank's own inputs go (``slots``); ``block`` is what each rank
    owns (elements, block-rows, rows or heads) of ``extent``.
    """

    kind: str
    op: str
    engine: str
    backend: str
    width: int
    statics: tuple
    slots: Tuple[int, ...]
    kwargs: Dict[str, Any]
    block: int
    extent: int
    halo: int = 0
    ncols: int = 0


class _Lowered:
    """One lowered call: its program, how live arguments become each
    rank's inputs (``prep``) and how the ranks' outputs become the
    unsharded result (``post``).  ``wired`` says whether the program
    exchanges rows (the stencil's halos)."""

    def __init__(self, program: _Program, prep: Callable, post: Callable,
                 wired: bool):
        self.program = program
        self.prep = prep
        self.post = post
        self.wired = wired
        self.warmed = False


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy in this rank's own memory."""
    return t.clone(memory_format=torch.contiguous_format)


def _sync_like(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _launch(prog: _Program, call: list):
    from ..kernels import registry
    op = registry.get(prog.op)
    return op.engines[prog.engine](*call, backend=prog.backend,
                                   **prog.kwargs)


def _call(prog: _Program, local: tuple) -> list:
    call = list(prog.statics)
    for i, t in zip(prog.slots, local):
        call[i] = t
    return call


def _halo_exchange(prog: _Program, g, own: torch.Tensor):
    """Send this rank's edge rows to its neighbours, receive theirs."""
    r, halo = g.rank, prog.halo
    sends, recvs = {}, {}
    if r > 0:
        sends[r - 1] = recvs[r - 1] = own[:halo]
    if r < prog.width - 1:
        sends[r + 1] = own[prog.block - halo:]
        recvs[r + 1] = own[:halo]
    return g.exchange(sends, recvs)


def _stencil_step(prog: _Program, g, local: tuple) -> torch.Tensor:
    """Exchange halos, then ``steps`` fused steps of the kernel on the
    rank's in-domain rows.  Rows outside the domain (before row 0, the
    padding after the last row) are left out of the tile, so the
    kernel's zero boundary stands exactly where the reference's
    global-row domain mask re-zeroes them after every step."""
    (own,) = local
    r, block, rows = g.rank, prog.block, prog.extent
    got = _halo_exchange(prog, g, own)
    start, stop = r * block, min((r + 1) * block, rows)
    if stop <= start:               # a rank of padding rows only
        return torch.zeros_like(own)
    parts = [got[r - 1]] if r > 0 else []
    parts.append(own[:stop - start])
    if r < prog.width - 1:
        parts.append(got[r + 1][:max(0, min(prog.halo, rows - stop))])
    lo = parts[0].shape[0] if r > 0 else 0
    out = _launch(prog, _call(prog, (torch.cat(parts),)))
    mine = out[lo:lo + stop - start]
    if stop - start < block:
        mine = torch.cat([mine, mine.new_zeros((block - (stop - start),)
                                               + tuple(mine.shape[1:]))])
    return mine


def _bell_step(prog: _Program, g, local: tuple) -> torch.Tensor:
    from ..kernels.spmv.ref import BlockEll
    blocks, cols, x = local
    bell = BlockEll(blocks, cols, (blocks.shape[0] * blocks.shape[2],
                                   prog.ncols))
    return _launch(prog, [bell, x] + list(prog.statics[2:]))


def _plain_step(prog: _Program, g, local: tuple) -> torch.Tensor:
    return _launch(prog, _call(prog, local))


_STEPS = {"data": _plain_step, "head": _plain_step, "bell": _bell_step,
          "stencil": _stencil_step}


def _mesh_rank(ctx, prog: _Program, inputs: tuple, *, warmup: int,
               iters: int, twin_iters: int, out: bool) -> Dict[str, Any]:
    """One rank's share of a mesh call: take its inputs into its own
    memory, run ``warmup`` untimed steps, then ``iters`` timed ones
    (each between two barriers; rank 0's clock), then ``twin_iters`` of
    the exchange alone; answer rank 0's samples and, with ``out``, the
    last step's output."""
    g = ctx.group(prog.width)
    local = tuple(_own(t) for t in inputs)
    del inputs
    step = _STEPS[prog.kind]
    ref = local[0]
    res = None
    for _ in range(warmup):
        res = step(prog, g, local)
        _sync_like(ref)

    def timed(fn, n):
        samples = []
        for _ in range(n):
            _sync_like(ref)
            g.barrier()
            t0 = time.perf_counter()
            fn()
            _sync_like(ref)
            g.barrier()
            samples.append((t0, time.perf_counter() - t0))
        return samples

    last = [res]

    def one():
        last[0] = None          # the previous step's output, freed first
        last[0] = step(prog, g, local)

    walls = timed(one, iters)
    res = last[0]
    coll = timed(lambda: _halo_exchange(prog, g, local[0]), twin_iters)
    return {"walls": walls if g.rank == 0 else None,
            "coll": coll if g.rank == 0 else None,
            "out": res if out else None}


def _probe_rank(ctx, width: int, x: torch.Tensor, w_shard: torch.Tensor,
                x_shard: torch.Tensor, *, warmup: int,
                iters: int) -> Dict[str, Any]:
    """One rank's share of the overlap probe: each variant's product,
    then its timed iterations (between two barriers; rank 0's clock)."""
    from .collective_matmul import (gathered_matmul, rowparallel_matmul,
                                    weight_gathered_matmul)
    g = ctx.group(width)
    x, w_shard, x_shard = _own(x), _own(w_shard), _own(x_shard)
    variants = {
        "ring": lambda: weight_gathered_matmul(x, w_shard, g),
        "serialized": lambda: gathered_matmul(x, w_shard, g),
        "rowparallel": lambda: rowparallel_matmul(x_shard, w_shard, g),
    }
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        answer: Dict[str, Any] = {}
        for name, fn in variants.items():
            y = fn()
            for _ in range(warmup):
                fn()
            samples = []
            for _ in range(iters):
                _sync_like(x)
                g.barrier()
                t0 = time.perf_counter()
                fn()
                _sync_like(x)
                g.barrier()
                samples.append((time.perf_counter() - t0) * 1e6)
            answer[name] = y if g.rank == 0 else None
            answer[f"{name}_us"] = samples
        return answer
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


class MeshExecutor:
    """Run registry kernels on N ranks at once: the measured mesh.

    The measured counterpart of :class:`ShardedExecutor`: where that class
    launches the shards one after another and *models* the N-way time as
    the slowest shard, this one lowers the same plan to one program per
    rank of a :class:`~repro_torch.sharding.ranks.RankGroup` (N
    processes; see :func:`repro_torch.launch.mesh.host_device_count`) and
    measures the wall of the whole mesh step, exchange included.  Every
    rank launches the hand-written kernel of the engine the dispatcher
    picks (``backend="cuda"``, all ranks on ``cuda:0``) or runs its plain
    version (``backend="plain"``, on the CPU).

    Per shard kind, as the reference's lowerings:

    * ``data``: arrays flatten, zero-pad to ``N x L`` and split; each rank
      runs the kernel on its block (elementwise: padding is inert and
      cropped after).
    * ``rowblock`` with a halo (stencil): each rank owns ``L`` rows and
      receives ``halo = t*r`` rows from each neighbour (an edge receives
      nothing: the domain's zero boundary), then runs ``t`` fused steps
      on its in-domain rows; a halo wider than ``L`` raises the
      reference's ``ValueError``.
    * ``rowblock`` of block-ELL (SpMV): block-rows split, ``x``
      replicated.
    * ``head`` (decode attention): KV heads split (q on axis 1, K / V on
      axis 2), each rank's call carrying the unsharded ``B * KH`` as
      ``split_pairs`` so its split-S ranges are the unsharded call's.

    Ranks that share one card are time-sliced between their CUDA
    contexts, and gloo moves the halos through host memory: the wall is
    near the sum of the shards plus the exchange, not the slowest shard.
    """

    def __init__(self, num_shards: int, *, backend: str = "cuda",
                 dispatcher=None):
        from ..launch.mesh import _need_ranks
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        _need_ranks(self.num_shards, f"MeshExecutor({self.num_shards})")
        self.backend = backend
        self.dispatcher = (dispatcher if dispatcher is not None
                           else DEFAULT_DISPATCHER)
        self._flat = None
        self._lowered_cache: Dict[Any, _Lowered] = {}

    def _flat_dispatcher(self):
        if self.dispatcher.mesh_shards == 1:
            return self.dispatcher
        if self._flat is None:
            self._flat = Dispatcher(advisor=self.dispatcher.advisor,
                                    tuning=self.dispatcher.tuning)
        return self._flat

    @staticmethod
    def _group():
        from . import ranks
        return ranks.pool()

    def plan(self, op, *args, **kwargs) -> ShardPlan:
        """The ShardPlan this executor lowers for one call."""
        return plan_for(op, self.num_shards, *args, **kwargs)

    def engine_for(self, op, *args, engine: Optional[str] = None,
                   **kwargs) -> str:
        """The engine the ranks launch: *engine* when forced, else the
        dispatcher's pick under ``auto``."""
        return self._flat_dispatcher().resolve(
            op, *args, engine=engine or "auto", **kwargs)

    # -- lowering ----------------------------------------------------------

    def _lowered(self, op, plan: ShardPlan, args: tuple, kwargs: dict,
                 engine: Optional[str]) -> _Lowered:
        from ..core.dispatch import default_cache_key
        semantic = {k: v for k, v in kwargs.items()
                    if k not in op.tile_space}
        eng = self.engine_for(op, *args, engine=engine, **semantic)
        key = (op.name, plan.spec, eng, default_cache_key(*args, **kwargs))
        low = self._lowered_cache.get(key)
        if low is None:
            tile = self._flat_dispatcher().tile_params(op, eng, *args,
                                                       **semantic) or {}
            base = dict(op=op.name, engine=eng, backend=self.backend,
                        width=plan.spec.num_shards,
                        kwargs={**tile, **kwargs})
            kind = plan.spec.kind
            if kind == "data":
                low = self._lower_data(args, base)
            elif kind == "rowblock" and hasattr(args[0], "blocks"):
                low = self._lower_bell(args, base)
            elif kind == "rowblock":
                low = self._lower_stencil(plan, args, base)
            else:
                low = self._lower_head(args, base)
            self._lowered_cache[key] = low
        return low

    @staticmethod
    def _lower_data(args: tuple, base: dict) -> _Lowered:
        width = base["width"]
        slots = tuple(i for i, a in enumerate(args) if _is_split(a))
        shape = tuple(args[slots[0]].shape)
        n = math.prod(shape)
        block = _ceil_div(n, width)
        statics = tuple(None if i in slots else a
                        for i, a in enumerate(args))
        prog = _Program(kind="data", statics=statics, slots=slots,
                        block=block, extent=n, **base)

        def prep(live):
            flats = []
            for i in slots:
                f = live[i].reshape(-1)
                if block * width > n:
                    f = torch.cat([f, f.new_zeros(block * width - n)])
                flats.append(f)
            return [tuple(f[r * block:(r + 1) * block] for f in flats)
                    for r in range(width)]

        def post(outs):
            return torch.cat(outs)[:n].reshape(shape)

        return _Lowered(prog, prep, post, wired=False)

    @staticmethod
    def _lower_bell(args: tuple, base: dict) -> _Lowered:
        width = base["width"]
        nbr, bm = int(args[0].blocks.shape[0]), args[0].bm
        block = _ceil_div(nbr, width)
        prog = _Program(kind="bell", statics=(None, None) + tuple(args[2:]),
                        slots=(0, 1), block=block, extent=nbr,
                        ncols=int(args[0].shape[1]), **base)

        def prep(live):
            blocks, cols, x = live[0].blocks, live[0].cols, live[1]
            if block * width > nbr:
                grow = block * width - nbr
                blocks = torch.cat([blocks, blocks.new_zeros(
                    (grow,) + tuple(blocks.shape[1:]))])
                cols = torch.cat([cols, cols.new_zeros(
                    (grow,) + tuple(cols.shape[1:]))])
            return [(blocks[r * block:(r + 1) * block],
                     cols[r * block:(r + 1) * block], x)
                    for r in range(width)]

        def post(outs):
            return torch.cat(outs)[:nbr * bm]

        return _Lowered(prog, prep, post, wired=False)

    @staticmethod
    def _lower_stencil(plan: ShardPlan, args: tuple,
                       base: dict) -> _Lowered:
        width, halo = base["width"], plan.spec.halo
        rows = int(args[0].shape[0])
        block = _ceil_div(rows, width)
        if halo > block:
            raise ValueError(
                f"stencil halo {halo} exceeds the {block} rows each of "
                f"{width} shards owns; a neighbour exchange cannot reach "
                f"{halo} rows away -- use fewer shards or a larger domain")
        prog = _Program(kind="stencil", statics=(None,) + tuple(args[1:]),
                        slots=(0,), block=block, extent=rows, halo=halo,
                        **base)

        def prep(live):
            u = live[0]
            if block * width > rows:
                u = torch.cat([u, u.new_zeros((block * width - rows,)
                                              + tuple(u.shape[1:]))])
            return [(u[r * block:(r + 1) * block],) for r in range(width)]

        def post(outs):
            return torch.cat(outs)[:rows]

        return _Lowered(prog, prep, post, wired=width > 1)

    @staticmethod
    def _lower_head(args: tuple, base: dict) -> _Lowered:
        width = base["width"]
        q = args[0]
        heads = int(q.shape[1])
        block = _ceil_div(heads, width)
        kwargs = dict(base.pop("kwargs"))
        if kwargs.get("split_pairs") is None:
            kwargs["split_pairs"] = int(q.shape[0]) * heads
        prog = _Program(kind="head",
                        statics=(None, None, None) + tuple(args[3:]),
                        slots=(0, 1, 2), block=block, extent=heads,
                        kwargs=kwargs, **base)

        def prep(live):
            q, k, v = live[0], live[1], live[2]
            if block * width > heads:
                grow = block * width - heads
                q = torch.cat([q, q.new_zeros(q.shape[0], grow,
                                              *q.shape[2:])], dim=1)
                k = torch.cat([k, k.new_zeros(*k.shape[:2], grow,
                                              k.shape[3])], dim=2)
                v = torch.cat([v, v.new_zeros(*v.shape[:2], grow,
                                              v.shape[3])], dim=2)
            return [(q[:, r * block:(r + 1) * block],
                     k[:, :, r * block:(r + 1) * block],
                     v[:, :, r * block:(r + 1) * block])
                    for r in range(width)]

        def post(outs):
            return torch.cat(outs, dim=1)[:, :heads]

        return _Lowered(prog, prep, post, wired=False)

    # -- execution ---------------------------------------------------------

    def _call(self, low: _Lowered, args: tuple, **kw) -> List[Dict]:
        with TRACER.span("pad_prep", layer="mesh",
                         kernel=low.program.op):
            per_rank = low.prep(args)
        return self._group().call(low.program.width, _mesh_rank,
                                  [(low.program, inp) for inp in per_rank],
                                  **kw)

    def run(self, op, *args, engine: Optional[str] = None,
            plan: Optional[ShardPlan] = None, **kwargs) -> MeshRun:
        """One measured mesh step: warm once per lowered call, then time
        one step; the ranks' outputs combined into the unsharded one."""
        if plan is None:
            plan = self.plan(op, *args, **kwargs)
        low = self._lowered(op, plan, args, kwargs, engine)
        with TRACER.span("mesh_run", layer="mesh", kernel=op.name,
                         devices=low.program.width, kind=plan.spec.kind):
            answers = self._call(low, args, warmup=0 if low.warmed else 1,
                                 iters=1, twin_iters=0, out=True)
            low.warmed = True
            ((t0, wall),) = answers[0]["walls"]
            TRACER.emit("mesh_step", layer="mesh", start_s=t0, dur_s=wall,
                        kernel=op.name, devices=low.program.width)
            with TRACER.span("reassembly", layer="mesh", kernel=op.name):
                out = low.post([a["out"] for a in answers])
        return MeshRun(out=out, plan=plan, devices=low.program.width,
                       wall_s=wall)

    def measure(self, op, *args, plan: Optional[ShardPlan] = None,
                engine: Optional[str] = None, warmup: int = 2,
                iters: int = 5, **kwargs) -> Dict[str, Any]:
        """The schema-6 ``mesh_exec`` evidence for one call.

        Three measurements, each the median of ``iters`` after
        ``warmup``:

        * ``mesh_wall_us``: whole mesh steps (every rank's kernel and
          exchange), between two barriers, on rank 0's clock;
        * ``collective_us``: the exchange alone, the same way; 0.0 when
          the plan wires no bytes;
        * ``virtual_us``: the slowest plan shard alone on this process's
          device with the same kernel, timed by ``time_fn`` (CUDA events
          on the card), the virtual clock's charge.
        """
        if plan is None:
            plan = self.plan(op, *args, **kwargs)
        low = self._lowered(op, plan, args, kwargs, engine)
        prog = low.program
        with TRACER.span("mesh_measure", layer="mesh", kernel=op.name,
                         devices=prog.width, kind=plan.spec.kind):
            answers = self._call(low, args, warmup=warmup, iters=iters,
                                 twin_iters=iters if low.wired else 0,
                                 out=False)
            low.warmed = True
            walls, coll = answers[0]["walls"], answers[0]["coll"]
            if TRACER.enabled:
                for i, (t0, dt) in enumerate(walls):
                    TRACER.emit("mesh_step", layer="mesh", start_s=t0,
                                dur_s=dt, iter=i, kernel=op.name,
                                devices=prog.width)
                for i, (t0, dt) in enumerate(coll):
                    TRACER.emit("collective", layer="mesh", start_s=t0,
                                dur_s=dt, iter=i, kernel=op.name,
                                devices=prog.width)
            t_mesh = timing_of([dt * 1e6 for _, dt in walls])
            collective_us = (timing_of([dt * 1e6 for _, dt in coll])
                             .median_us if coll else 0.0)
            fn = op.engines[prog.engine]
            shard_us = []
            for i, shard in enumerate(plan.shards):
                sa, skw = shard_call(plan, shard, args, kwargs)
                skw = {**prog.kwargs, **skw}
                shard_us.append(time_fn(
                    lambda: fn(*sa, backend=self.backend, **skw),
                    warmup=warmup, iters=iters, label="shard_ref",
                    layer="mesh", kernel=op.name, shard=i).median_us)
                del sa, skw
        virtual_us = max(shard_us) if shard_us else 0.0
        return {
            "mode": "mesh",
            "devices": int(prog.width),
            "mesh_wall_us": round(t_mesh.median_us, 1),
            "mesh_iqr_us": round(t_mesh.iqr_us, 1),
            "collective_us": round(collective_us, 1),
            "virtual_us": round(virtual_us, 1),
            "skew": round(t_mesh.median_us / virtual_us, 4)
            if virtual_us > 0 else 0.0,
        }

    def overlap_probe(self, *, rows: int = 128, contract: int = 2048,
                      cols: int = 256, seed: int = 0, warmup: int = 2,
                      iters: int = 5) -> Dict[str, Any]:
        """§4.1's lesson measured on the live ranks: overlapped or not.

        Times :func:`~repro_torch.sharding.collective_matmul.
        weight_gathered_matmul` (weight shards rotate a ring, each hop's
        product issued while the next shard is on the wire) against the
        serialized ``x @ all_gather(w)`` and the row-parallel
        :func:`rowparallel_matmul`, after asserting each against the
        unsharded product (max error 1e-2, as the reference).
        ``overlap_gain`` is serialized over ring wall time.
        """
        import numpy as np
        width = self.num_shards
        contract = width * _ceil_div(contract, width)
        k = contract // width
        device = "cuda" if self.backend == "cuda" else "cpu"
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal((rows, contract))
                             .astype(np.float32)).to(device)
        w = torch.from_numpy(rng.standard_normal((contract, cols))
                             .astype(np.float32)).to(device)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            want = x @ w
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        answers = self._group().call(
            width, _probe_rank,
            [(width, x, w[r * k:(r + 1) * k], x[:, r * k:(r + 1) * k])
             for r in range(width)], warmup=warmup, iters=iters)
        first = answers[0]
        for name in ("ring", "serialized", "rowparallel"):
            err = float((first[name] - want).abs().max())
            if err > 1e-2:
                raise AssertionError(
                    f"overlap probe {name} diverged from x @ w (max err "
                    f"{err:.3g})")
        med = {name: timing_of(first[f"{name}_us"]).median_us
               for name in ("ring", "serialized", "rowparallel")}
        return {
            "devices": int(width),
            "shape": [rows, contract, cols],
            "ring_us": round(med["ring"], 1),
            "serialized_us": round(med["serialized"], 1),
            "rowparallel_us": round(med["rowparallel"], 1),
            "overlap_gain": round(med["serialized"] / med["ring"], 3)
            if med["ring"] > 0 else 0.0,
        }
