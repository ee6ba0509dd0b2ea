"""SLO-aware engine/shard routing + the online-tuning batch executor.

The static serving stack routes with two offline facts: the memoized §6
Advice (engine, from the Eq. 2 intensity vs. Eq. 4 machine balance) and
the loaded ``tuned.json`` (tile shape).  Under live load two more signals
exist that neither fact sees -- queue depth and SLO headroom -- and this
module turns them into the two decisions a serving control plane owns:

* **Shard width** (:class:`SLORouter`): grow the mesh split when the
  queue is deep and the head request's SLO headroom is thin, shrink it
  back when the queue drains.  Eq. 2 intensity is invariant under the
  data split, so the *engine* decision is identical at every width.
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
claim replays it.  :class:`OnlineKernelBatchExecutor` runs at width 1; a
router that may grow the width needs the sharded executor, which waits
for ROADMAP Queue 1 item 13, and is refused when the executor is built.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ..core.dispatch import normalize_engine
from ..obs.trace import TRACER
from ..tuning.online import ArmChoice, OnlineTuner
from .batcher import MESH_WAITS, KernelBatchExecutor
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

    Two deltas from the base executor: the scheduler's :meth:`on_dequeue`
    signals feed an optional :class:`SLORouter` (the exploration gate),
    and packable launches take their tile config from the
    :class:`~repro_torch.tuning.online.OnlineTuner` instead of the static
    TuningPolicy (one arm per batch -- the measured batch compute time is
    the arm's observation).

    Engine selection is inherited unchanged -- the bandit tunes tiles
    *within* the engine §6 Advice fixed, so no online choice can cross
    the Eq. 23/24 ceiling.  The width stays 1: a router whose
    ``max_width`` exceeds 1 raises ``NotImplementedError`` (the sharded
    executor waits for ROADMAP Queue 1 item 13).
    """

    def __init__(self, engine: str = "auto", *, max_batch: int = 8,
                 backend: str = "cuda", seed: int = 0,
                 tuner: Optional[OnlineTuner] = None,
                 router: Optional[SLORouter] = None):
        if router is not None and router.max_width > 1:
            raise NotImplementedError(
                f"an SLO router of max_width {router.max_width}: "
                f"{MESH_WAITS}")
        super().__init__(engine, max_batch=max_batch, backend=backend,
                         seed=seed)
        self.tuner = tuner
        self.router = router
        self._explore = True
        self._pending: Optional[ArmChoice] = None
        self._tunable = False
        self._batch_rows = 0

    # -- control plane -----------------------------------------------------

    def on_dequeue(self, batch: List[Request], *, clock_s: float,
                   queue_depth: int) -> None:
        """The scheduler's pre-launch signal: route this batch.

        Resolves the batch's Advice engine (memoized -- a dict hit in
        steady state) and asks the router for the exploration gate.
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

    # -- tile injection ----------------------------------------------------

    def _tile_override(self, op, engine: str, dtype: str):
        """The bandit's arm for this launch (one selection per batch)."""
        if (self.tuner is None or not self._tunable
                or self._pending is not None):
            return None
        choice = self.tuner.select(op, engine, dtype,
                                   explore=self._explore,
                                   size=self._batch_rows)
        self._pending = choice
        return dict(choice.params)

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
