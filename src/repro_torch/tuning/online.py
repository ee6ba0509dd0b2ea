"""Online tile autotuning: a budgeted, deterministic UCB bandit.

The offline tuner (:mod:`repro_torch.tuning.tuner`) times a family's tile
candidates once, against canonical inputs, on whatever card ran
``python -m repro_torch.bench tune`` — and the paper's own point (§6:
engine choice for memory-bound kernels is a bandwidth property, Eq.
23/24) says that is all an *engine* decision needs.  A *tile* decision is softer: the
winning block shape shifts with batch size, shard width, and dtype,
which a serving session observes for free in its measured batch
compute times.  :class:`OnlineTuner` closes that loop: one bandit per
``(kernel, engine, dtype, shard_shape)`` key whose arms are the
family's declared ``tile_space`` candidates, warm-started from the
loaded ``tuned.json`` and re-ranked from live observations.

Design constraints, in order:

1. **Determinism.**  Serving replay (same seed, same chaos spec) must
   reproduce the bandit's decisions bit-for-bit, so there is no RNG
   anywhere in the policy.  Unexplored arms are taken in index order;
   ties in the UCB score break toward the lowest index; observations
   are rounded to 3 decimals (nanosecond-scale noise) *before* they
   touch the statistics, so :func:`replay` can re-derive the full arm
   sequence from a record's event log alone — the ``online_ceiling``
   claim does exactly that.
2. **Budgeted exploration.**  Exploration (round-robin over untried
   arms, then lowest-confidence-bound UCB) only runs while the key's
   total pull count is under ``budget`` *and* the caller's ``explore``
   flag is set — the SLO router clears it when p99 headroom is thin.
   Past budget the bandit exploits: lowest observed mean, forever.
3. **Ceiling safety.**  The bandit never chooses an *engine* — arms
   are tile configurations only, within the engine §6 Advice already
   fixed.  An adaptive tuner can therefore never "discover" a
   matrix-engine win Eq. 23/24 forbids; the ``online_ceiling`` claim
   re-verifies this invariant on every recorded decision.

Regret bookkeeping: each event's ``regret_us`` is the observation
minus the best observation seen so far for that key (including this
one), so it is ``>= 0`` and exactly ``0`` whenever a new best lands.
``warm_us`` — the first in-session observation of the warm-start arm —
anchors "regret vs. warm-start" readings; the committed cache's own
``best_us`` is recorded as ``committed_us`` but never compared against
live walls (offline kernel timings and serving batch walls, which
include the host's launch path, are different clocks).

Winners flow back through :meth:`OnlineTuner.to_entries` as
``source="online"`` :class:`~repro_torch.tuning.cache.TunedEntry` rows and
the cache's faster-wins merge — an online winner only displaces a
committed entry when its measured mean beats the committed ``best_us``
on the same key, and per-shard keys (which the offline tuner never
populated) gain their first entries this way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence

from .cache import (FULL_SHARD_SHAPE, SOURCE_ONLINE, TunedEntry,
                    TuningCache, shard_shape_of)
from .tuner import candidates

__all__ = ["ArmChoice", "DEFAULT_BONUS", "DEFAULT_BUDGET", "KeyState",
           "OnlineTuner", "replay", "select_index"]

#: Default exploration pull budget per bandit key.
DEFAULT_BUDGET = 8

#: Default UCB exploration bonus multiplier.  Scales the confidence
#: half-width ``sqrt(ln N / n_i)`` in the lowest-confidence-bound
#: score; larger values explore more aggressively within the budget.
DEFAULT_BONUS = 1.0

#: ``warm_source`` tag: arm 0 came from a committed tuned.json entry.
WARM_CACHE = "cache"
#: ``warm_source`` tag: no cache entry for the key; arm 0 is the
#: family's static default config.
WARM_DEFAULT = "default"


def _round_us(us: float) -> float:
    """Observations rounded to 3 decimals (ns-scale) before any use.

    The rounding happens *before* an observation reaches the running
    statistics, so the event log's ``observed_us`` values are exactly
    the numbers the policy computed with — :func:`replay` depends on
    this to re-derive decisions bit-for-bit.
    """
    return round(float(us), 3)


def select_index(pulls: Sequence[int], means: Sequence[float],
                 total: int, budget: int, explore: bool,
                 bonus: float = DEFAULT_BONUS) -> int:
    """The pure selection policy: which arm index to pull next.

    * ``explore`` false, or budget exhausted (``total >= budget``):
      exploit — the pulled arm with the lowest mean (lowest index on
      ties); arm 0 if nothing was pulled yet.
    * otherwise, any untried arm: the lowest-index one (round-robin
      first pass, warm-start arm 0 first of all).
    * otherwise lowest-confidence-bound UCB for minimisation:
      ``mean_i - bonus * sqrt(ln(total) / pulls_i)``, lowest index on
      ties — optimism in the face of uncertainty, pointed at a
      minimisation objective.

    Shared verbatim by :meth:`OnlineTuner.select` and :func:`replay`
    so live decisions and record replays cannot diverge.
    """
    k = len(pulls)
    if k == 0:
        raise ValueError("select_index: no arms")
    if not explore or total >= budget:
        pulled = [i for i in range(k) if pulls[i] > 0]
        if not pulled:
            return 0
        return min(pulled, key=lambda i: (means[i], i))
    for i in range(k):
        if pulls[i] == 0:
            return i
    logn = math.log(max(total, 1))
    return min(range(k),
               key=lambda i: (means[i] - bonus * math.sqrt(
                   logn / pulls[i]), i))


def replay(n_arms: int, budget: int,
           events: Sequence[Mapping[str, Any]], *,
           bonus: float = DEFAULT_BONUS) -> List[int]:
    """Re-derive a key's arm sequence from its recorded event log.

    Feeds each event's ``explore`` flag and ``observed_us`` through
    :func:`select_index` with statistics rebuilt from the prior
    events, returning the arm index the policy *would* have pulled at
    every step.  A faithful record satisfies
    ``[e["arm"] for e in events] == replay(...)`` — the byte-identical
    replay check behind the ``online_ceiling`` claim.
    """
    pulls = [0] * int(n_arms)
    sums = [0.0] * int(n_arms)
    total = 0
    out: List[int] = []
    for ev in events:
        means = [sums[i] / pulls[i] if pulls[i] else 0.0
                 for i in range(int(n_arms))]
        idx = select_index(pulls, means, total, budget,
                           bool(ev["explore"]), bonus)
        out.append(idx)
        arm = int(ev["arm"])
        if not 0 <= arm < int(n_arms):
            raise ValueError(f"replay: arm {arm} out of range "
                             f"[0, {n_arms})")
        pulls[arm] += 1
        sums[arm] += _round_us(ev["observed_us"])
        total += 1
    return out


@dataclasses.dataclass(frozen=True)
class ArmChoice:
    """One selection: the key, arm index, params, and explore flag.

    Handed back to :meth:`OnlineTuner.observe` with the measured
    compute time once the launch lands.
    """

    key: str
    arm: int
    params: Mapping[str, int]
    explore: bool


class KeyState:
    """One bandit key's arms, statistics, and event log.

    Arm 0 is always the warm-start configuration — the committed
    cache's winner when one exists for the key (``warm_source ==
    'cache'``), the family's static default otherwise.
    """

    def __init__(self, key: str, kernel: str, engine: str, dtype: str,
                 shard_shape: str, arms: List[Dict[str, int]],
                 warm_source: str,
                 committed_us: Optional[float] = None):
        self.key = key
        self.kernel = kernel
        self.engine = engine
        self.dtype = dtype
        self.shard_shape = shard_shape
        self.arms = arms
        self.warm_source = warm_source
        self.committed_us = committed_us
        self.pulls = [0] * len(arms)
        self.sums = [0.0] * len(arms)
        self.total = 0
        self.events: List[Dict[str, Any]] = []
        self.warm_us: Optional[float] = None
        self.best_us: Optional[float] = None
        self.size = 0

    @property
    def means(self) -> List[float]:
        """Per-arm mean observed µs (0.0 for untried arms)."""
        return [self.sums[i] / self.pulls[i] if self.pulls[i] else 0.0
                for i in range(len(self.arms))]

    @property
    def winner(self) -> int:
        """The exploit choice right now: pulled arm with lowest mean."""
        pulled = [i for i in range(len(self.arms)) if self.pulls[i] > 0]
        if not pulled:
            return 0
        means = self.means
        return min(pulled, key=lambda i: (means[i], i))

    def payload(self) -> Dict[str, Any]:
        """The key's JSON block for the serving record."""
        return {
            "kernel": self.kernel,
            "engine": self.engine,
            "dtype": self.dtype,
            "shard_shape": self.shard_shape,
            "arms": [dict(sorted(a.items())) for a in self.arms],
            "warm_arm": 0,
            "warm_source": self.warm_source,
            "warm_us": self.warm_us,
            "committed_us": self.committed_us,
            "best_us": self.best_us,
            "winner": self.winner,
            "events": [dict(e) for e in self.events],
        }


class OnlineTuner:
    """The per-session bandit bank: one :class:`KeyState` per key.

    *cache* (the committed tuned.json, already loaded) supplies
    warm-start arms; *hw_model* scopes cache lookups; *budget* caps
    exploration pulls per key; *bonus* scales the UCB confidence term.

    Arms are tile configurations *within* the engine the §6 Advice
    already fixed — online tuning can re-rank tiles but can never
    cross the Eq. 23/24 ceiling to a matrix-engine "win".
    """

    def __init__(self, budget: int = DEFAULT_BUDGET, *,
                 cache: Optional[TuningCache] = None,
                 hw_model: str = "", bonus: float = DEFAULT_BONUS):
        if budget < 1:
            raise ValueError(f"online tuner budget must be >= 1, "
                             f"got {budget}")
        self.budget = int(budget)
        self.cache = cache
        self.hw_model = hw_model
        self.bonus = float(bonus)
        self._keys: Dict[str, KeyState] = {}

    @staticmethod
    def key_of(kernel: str, engine: str, dtype: str,
               shard_shape: str) -> str:
        """The flat record/bandit key: fields joined with ``|``."""
        return "|".join((kernel, engine, dtype, shard_shape))

    def __len__(self) -> int:
        return len(self._keys)

    def __iter__(self):
        return iter(self._keys.values())

    def state_for(self, op, engine: str, dtype: str,
                  shard_shape: str = FULL_SHARD_SHAPE) -> KeyState:
        """The key's state, building arms + warm-start on first touch.

        Arms are :func:`repro_torch.tuning.tuner.candidates` under this
        tuner's budget (static default first).  A committed cache
        entry for the exact key is promoted to arm 0 — prepended when
        the budget's candidate cut dropped it — so the warm
        configuration is always the first one tried.
        """
        key = self.key_of(op.name, engine, dtype, shard_shape)
        state = self._keys.get(key)
        if state is not None:
            return state
        arms = candidates(op, self.budget)
        warm_source, committed_us = WARM_DEFAULT, None
        if self.cache is not None:
            entry = self.cache.lookup(op.name, engine, dtype,
                                      self.hw_model, shard_shape)
            if entry is not None:
                warm = {k: int(v) for k, v in dict(entry.params).items()}
                if warm in arms:
                    arms.remove(warm)
                arms.insert(0, warm)
                warm_source, committed_us = WARM_CACHE, entry.best_us
        state = KeyState(key, op.name, engine, dtype, shard_shape,
                         arms, warm_source, committed_us)
        self._keys[key] = state
        return state

    def select(self, op, engine: str, dtype: str, *,
               num_shards: int = 1, explore: bool = True,
               size: int = 0) -> ArmChoice:
        """Pick the next tile config for one launch of this key.

        *explore* false (the router's thin-SLO-headroom signal) forces
        the exploit arm.  *size* records the batch row count the
        observation will come from (persisted winners report it).
        """
        state = self.state_for(op, engine, dtype,
                               shard_shape_of(num_shards))
        if size:
            state.size = max(state.size, int(size))
        idx = select_index(state.pulls, state.means, state.total,
                           self.budget, explore, self.bonus)
        return ArmChoice(state.key, idx, dict(state.arms[idx]),
                         bool(explore))

    def observe(self, choice: ArmChoice,
                observed_us: float) -> Dict[str, Any]:
        """Fold one measured compute time into the chosen arm.

        Rounds to 3 decimals first (see :func:`replay`), appends the
        event, and updates the running statistics.  Returns the event
        dict that entered the log.
        """
        state = self._keys[choice.key]
        obs = _round_us(observed_us)
        best = obs if state.best_us is None else min(state.best_us, obs)
        event = {
            "arm": int(choice.arm),
            "explore": bool(choice.explore),
            "observed_us": obs,
            "regret_us": _round_us(obs - best),
        }
        state.events.append(event)
        state.pulls[choice.arm] += 1
        state.sums[choice.arm] += obs
        state.total += 1
        state.best_us = best
        if choice.arm == 0 and state.warm_us is None:
            state.warm_us = obs
        return event

    @property
    def decisions(self) -> int:
        """Total observed pulls across every key."""
        return sum(s.total for s in self._keys.values())

    @property
    def regret_us_total(self) -> float:
        """Sum of per-event regret across every key (µs)."""
        return _round_us(sum(e["regret_us"]
                             for s in self._keys.values()
                             for e in s.events))

    def payload(self) -> Dict[str, Any]:
        """The serving record's ``tuning`` block (``tuning_events``)."""
        return {
            "mode": "online",
            "budget": self.budget,
            "bonus": self.bonus,
            "decisions": self.decisions,
            "regret_us_total": self.regret_us_total,
            "keys": {key: state.payload()
                     for key, state in sorted(self._keys.items())},
        }

    def to_entries(self) -> List[TunedEntry]:
        """Observed winners as ``source='online'`` cache entries.

        One entry per key that saw at least one pull: the exploit
        arm's mean as ``best_us``, the warm arm's mean as
        ``default_us`` (same-session walls — never the committed
        cache's offline µs).  Feed through
        :meth:`~repro_torch.tuning.cache.TuningCache.merge` so an online
        winner only displaces a committed entry it actually beats.
        """
        out: List[TunedEntry] = []
        for state in self._keys.values():
            if state.total == 0:
                continue
            means = state.means
            win = state.winner
            base_us = means[0] if state.pulls[0] else means[win]
            out.append(TunedEntry(
                kernel=state.kernel, engine=state.engine,
                dtype=state.dtype, hw_model=self.hw_model,
                params=dict(state.arms[win]),
                best_us=_round_us(means[win]),
                default_us=_round_us(base_us),
                size=int(state.size), source=SOURCE_ONLINE,
                budget=self.budget,
                shard_shape=state.shard_shape))
        return out
