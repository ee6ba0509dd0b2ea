"""SLO-aware engine/shard routing + the online-tuning batch executor.

The static serving stack routes with two offline facts: the memoized §6
Advice (engine, from the Eq. 2 intensity vs. Eq. 4 machine balance) and
the loaded ``tuned.json`` (tile shape).  Under live load two more signals
exist that neither fact sees -- queue depth and SLO headroom -- and this
module turns them into the two decisions a serving control plane owns:

* **Shard width** (:class:`SLORouter`): grow the mesh split when the
  queue is deep and the head request's SLO headroom is thin, shrink it
  back when the queue drains.  Width changes re-plan through
  ``Dispatcher.set_mesh`` so the memoized Advice carries the right
  ShardSpecs -- and Eq. 2 intensity is invariant under the data split,
  so the *engine* decision is identical at every width.
* **Exploration** (:class:`OnlineKernelBatchExecutor` +
  :class:`repro_torch.tuning.online.OnlineTuner`): each packed launch may
  try a bandit-chosen tile arm instead of the cached winner, but only
  while the router's ``explore`` gate is open (shallow queue, ample
  headroom) -- tail latency never pays for curiosity under pressure.

What the router deliberately does **not** own: overriding the Advice
engine.  The paper's Eq. 23/24 ceiling makes any matrix-engine
"discovery" for memory-bound work a modeling error by construction, so
:meth:`SLORouter.decide` records the Advice engine it was handed and
routes width/exploration around it -- the ``online_ceiling`` claim
re-verifies every recorded decision against the ceiling.

:class:`SLORouter` is the reference's pure policy, ported whole: the
claim replays it.  Every decision is appended to the router's log (and
emitted as a ``route`` trace instant on the virtual clock).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ..core.dispatch import DEFAULT_DISPATCHER, normalize_engine
from ..obs.trace import TRACER
from ..sharding import ShardedExecutor
from ..tuning.online import ArmChoice, OnlineTuner
from .batcher import KernelBatchExecutor
from .requests import Request

__all__ = ["OnlineKernelBatchExecutor", "RouterDecision", "SLORouter"]


@dataclasses.dataclass(frozen=True)
class RouterDecision:
    """One routing decision at a batch dequeue.

    ``engine`` is the §6 Advice engine the router was handed -- never
    overridden (see the module docstring); ``width`` is the mesh shard
    width the next launch runs at; ``explore`` gates whether the tile
    bandit may try a non-exploit arm; ``reason`` names which rule fired
    (``grow`` / ``shrink`` / ``hold``).
    """

    clock_s: float      # virtual-clock dequeue time
    engine: str         # 'vector' | 'matrix' -- the Advice engine
    width: int          # mesh shard width for the launch
    queue_depth: int    # admitted-but-unserved requests (incl. batch)
    headroom_ms: float  # slo_ms minus the head request's wait so far
    explore: bool       # may the tile bandit explore this launch?
    reason: str         # 'grow' | 'shrink' | 'hold'

    def to_json(self) -> Dict[str, Any]:
        """The decision as a plain JSON-serializable dict."""
        d = dataclasses.asdict(self)
        d["clock_s"] = round(self.clock_s, 6)
        d["headroom_ms"] = round(self.headroom_ms, 3)
        return d


class SLORouter:
    """Queue-depth + SLO-headroom policy for width and exploration.

    The router owns width and exploration only -- never the engine.

    Deterministic and RNG-free (serving replay must reproduce it): width
    doubles when ``queue_depth >= grow_depth`` *and* headroom is below
    ``pressure_frac`` of the SLO, halves when the queue has drained to
    ``shrink_depth`` or fewer, and holds otherwise -- the two thresholds
    are the hysteresis band that keeps the mesh from thrashing.
    Exploration opens only when the queue is shallow and headroom is at
    least ``explore_frac`` of the SLO.
    """

    def __init__(self, *, slo_ms: float = 50.0, max_width: int = 4,
                 grow_depth: int = 16, shrink_depth: int = 2,
                 pressure_frac: float = 0.5,
                 explore_frac: float = 0.5):
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        if max_width < 1:
            raise ValueError(f"max_width must be >= 1, got {max_width}")
        if shrink_depth >= grow_depth:
            raise ValueError(
                f"shrink_depth ({shrink_depth}) must be below "
                f"grow_depth ({grow_depth}) -- the hysteresis band")
        self.slo_ms = float(slo_ms)
        self.max_width = int(max_width)
        self.grow_depth = int(grow_depth)
        self.shrink_depth = int(shrink_depth)
        self.pressure_frac = float(pressure_frac)
        self.explore_frac = float(explore_frac)
        self.width = 1
        self.decisions: List[RouterDecision] = []

    def decide(self, *, clock_s: float, engine: str, queue_depth: int,
               oldest_wait_ms: float) -> RouterDecision:
        """One routing decision from the dequeue-time signals.

        *engine* is the Advice engine for the batch about to launch --
        recorded, never changed.  Appends the decision to
        :attr:`decisions` and emits a ``route`` trace instant.
        """
        headroom_ms = self.slo_ms - float(oldest_wait_ms)
        width, reason = self.width, "hold"
        if (queue_depth >= self.grow_depth
                and headroom_ms < self.slo_ms * self.pressure_frac
                and width < self.max_width):
            width, reason = min(self.max_width, width * 2), "grow"
        elif queue_depth <= self.shrink_depth and width > 1:
            width, reason = max(1, width // 2), "shrink"
        self.width = width
        explore = (queue_depth < self.grow_depth
                   and headroom_ms >= self.slo_ms * self.explore_frac)
        decision = RouterDecision(
            clock_s=float(clock_s), engine=engine, width=width,
            queue_depth=int(queue_depth), headroom_ms=headroom_ms,
            explore=explore, reason=reason)
        self.decisions.append(decision)
        TRACER.instant("route", layer="router", at_s=clock_s,
                       engine=engine, width=width,
                       depth=int(queue_depth),
                       headroom_ms=round(headroom_ms, 3),
                       explore=explore, reason=reason)
        return decision

    def payload(self) -> Dict[str, Any]:
        """The record's router block: policy knobs + decision log."""
        return {
            "slo_ms": self.slo_ms,
            "max_width": self.max_width,
            "grow_depth": self.grow_depth,
            "shrink_depth": self.shrink_depth,
            "pressure_frac": self.pressure_frac,
            "explore_frac": self.explore_frac,
            "decisions": [d.to_json() for d in self.decisions],
        }


class OnlineKernelBatchExecutor(KernelBatchExecutor):
    """A :class:`KernelBatchExecutor` whose tiles are bandit-tuned live.

    Three deltas from the base executor: the scheduler's
    :meth:`on_dequeue` signals feed an optional :class:`SLORouter` (width
    + exploration gate); packable launches take their tile config from
    the :class:`~repro_torch.tuning.online.OnlineTuner` instead of the
    static TuningPolicy (one arm per batch -- the measured batch compute
    time is the arm's observation); and width changes rebuild the shard
    executor in place, dropping the plan/warm caches whose keys embed the
    old capacity.

    Engine selection is inherited unchanged -- the bandit tunes tiles
    *within* the engine §6 Advice fixed, so no online choice can cross
    the Eq. 23/24 ceiling.
    """

    def __init__(self, engine: str = "auto", *, max_batch: int = 8,
                 backend: str = "cuda", seed: int = 0,
                 tuner: Optional[OnlineTuner] = None,
                 router: Optional[SLORouter] = None,
                 dispatcher=None):
        super().__init__(engine, max_batch=max_batch, backend=backend,
                         seed=seed)
        self.tuner = tuner
        self.router = router
        self.dispatcher = (dispatcher if dispatcher is not None
                           else DEFAULT_DISPATCHER)
        self._explore = True
        self._pending: Optional[ArmChoice] = None
        self._tunable = False
        self._batch_rows = 0

    # -- control plane -----------------------------------------------------

    def on_dequeue(self, batch: List[Request], *, clock_s: float,
                   queue_depth: int) -> None:
        """The scheduler's pre-launch signal: route this batch.

        Resolves the batch's Advice engine (memoized -- a dict hit in
        steady state), asks the router for width + exploration, and
        applies a width change before the launch.
        """
        req = batch[0]
        advice = self.advice_for(req.kernel, req.size, req.dtype)
        engine = (advice.engine if self.engine == "auto"
                  else normalize_engine(self.engine))
        if self.router is None:
            return
        oldest_wait_ms = max(0.0, (clock_s - req.arrival_s) * 1e3)
        decision = self.router.decide(
            clock_s=clock_s, engine=engine, queue_depth=queue_depth,
            oldest_wait_ms=oldest_wait_ms)
        self._explore = decision.explore
        if decision.width != self.num_shards:
            self._set_width(decision.width)

    def _set_width(self, width: int) -> None:
        """Retarget the mesh width in place (the router's resize).

        Rebuilds the shard executor and drops the plan/warm caches --
        their keys embed the old capacity -- then re-plans the
        dispatcher's memoized Advice via ``set_mesh`` so ShardSpecs match
        the new width.  Canonical inputs survive: payloads are
        width-independent.
        """
        self.num_shards = max(1, int(width))
        self._shard_exec = (ShardedExecutor(self.num_shards,
                                            backend=self.backend)
                            if self.num_shards > 1 else None)
        self._plans.clear()
        self._warmed.clear()
        self.dispatcher.set_mesh(self.num_shards)

    # -- tile injection ----------------------------------------------------

    def _tile_override(self, op, engine: str, dtype: str):
        """The bandit's arm for this launch (one selection per batch)."""
        if (self.tuner is None or not self._tunable
                or self._pending is not None):
            return None
        choice = self.tuner.select(op, engine, dtype,
                                   num_shards=self.num_shards,
                                   explore=self._explore,
                                   size=self._batch_rows)
        self._pending = choice
        return dict(choice.params)

    def _sharded_compute(self, op, args: tuple, kwargs: dict,
                         engine: str, plan_key, warm_key) -> float:
        """The base shard launch, with the bandit arm riding kwargs.

        The ShardPlan is computed from the launch shape alone (tile params
        never change the split); the arm's ``tile_config`` rides the
        per-shard run kwargs, which the sharding layer forwards to each
        shard's dispatched call unchanged.
        """
        tile = self._tile_override(op, engine, plan_key[1])
        if tile is None:
            return super()._sharded_compute(op, args, kwargs, engine,
                                            plan_key, warm_key)
        plan = self._plans.get(plan_key)
        if plan is None:
            plan = self._plans[plan_key] = \
                self._shard_exec.plan(op, *args, **kwargs)
        warm_key = warm_key + (tuple(sorted(tile.items())),)
        run_kw = dict(kwargs)
        run_kw["tile_config"] = dict(tile)
        if warm_key not in self._warmed:
            self._shard_exec.run(op, *args, engine=engine, plan=plan,
                                 **run_kw)
            self._warmed.add(warm_key)
        return self._shard_exec.run(op, *args, engine=engine, plan=plan,
                                    **run_kw).parallel_s

    # -- execution ---------------------------------------------------------

    def execute(self, batch: List[Request]):
        """Launch one batch; its measured compute feeds the bandit."""
        kernel, dtype = batch[0].batch_key
        args, kwargs = self._canonical(kernel, batch[0].size, dtype)
        self._tunable = (self.tuner is not None
                         and self._packable(args, kwargs, batch[0].size))
        self._batch_rows = sum(r.size for r in batch)
        pending = None
        try:
            execution = super().execute(batch)
            pending = self._pending
        finally:
            self._tunable = False
            self._pending = None
        if pending is not None:
            self.tuner.observe(pending, execution.compute_s * 1e6)
        return execution

    # -- record plumbing ---------------------------------------------------

    def record_extras(self) -> Dict[str, Any]:
        """The serving record's ``tuning`` block for this session."""
        if self.tuner is None:
            return {}
        block = self.tuner.payload()
        if self.router is not None:
            block["router"] = self.router.payload()
        return {"tuning": block}
