"""Tile-configuration autotuning for the engine-dispatch runtime.

The paper's thesis -- memory-bound kernels live or die by bandwidth
saturation, not by which engine computes them (§6) -- only holds weight
if the baseline actually saturates bandwidth.  This package searches a
family's tile space on the card and persists the winners:

* :mod:`repro_torch.tuning.cache` -- the versioned ``tuned.json`` store
  (schema, environment fingerprint, merge semantics) consulted by
  ``repro_torch.core.dispatch.TuningPolicy``.
* :mod:`repro_torch.tuning.tuner` -- the search: enumerate a family's
  ``tile_space``, time each candidate's hand-written kernel, keep the
  fastest.
* :mod:`repro_torch.tuning.online` -- the budgeted deterministic UCB
  bandit that re-tunes tiles from live serving batch compute times,
  warm-started from the loaded cache and persisted back through the
  faster-wins merge.

The reference's ``tuning/proxy.py`` has no counterpart: its pure-XLA
stand-ins exist because interpret-mode Pallas cannot be timed, while the
port times its kernels themselves.

CLI entry point: ``python -m repro_torch.bench tune``.
"""
from .cache import (CACHE_SCHEMA, InterpretTimingError, TunedEntry,
                    TuningCache, env_fingerprint, shard_shape_of)
from .online import OnlineTuner, replay, select_index
from .tuner import candidates, default_params, tune_op

__all__ = [
    "CACHE_SCHEMA", "InterpretTimingError", "OnlineTuner", "TunedEntry",
    "TuningCache", "candidates", "default_params", "env_fingerprint",
    "replay", "select_index", "shard_shape_of", "tune_op",
]
