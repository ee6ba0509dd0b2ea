"""The tile-configuration search: enumerate, time, keep the winner.

For one (kernel family, engine, dtype) the tuner builds the family's
candidate grid from its declared ``tile_space`` (cross product of
per-parameter values, static defaults first), times each candidate, and
returns a :class:`~repro_torch.tuning.cache.TunedEntry` carrying the
winner plus the default's time so consumers can render the delta.

Timing sources:

* ``"cuda"`` (default) -- the family's engine entry point,
  ``op.engines[engine]``, timed by :func:`repro_torch.core.timing.time_fn`
  (CUDA events).  With ``backend="cuda"`` that is the hand-written kernel
  on the card (entry source ``"cuda"``); with ``backend="plain"`` the
  plain PyTorch version on the CPU, whose entry (source ``"plain"``) the
  cache refuses to persist
  (:class:`~repro_torch.tuning.cache.InterpretTimingError`).
* ``"proxy"`` -- the family's ``tune_proxy``.  The reference's proxies
  exist only because interpret-mode Pallas cannot be timed; the port
  times its kernels on the card, so every family's ``tune_proxy`` is None
  and every candidate is skipped with the reference's own message.

Candidates that fail to run (a block size an input cannot satisfy) are
recorded as skipped, never laundered into another configuration: an
autotuner that crashes on an invalid corner of its own space has failed
at its one job.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from .cache import SOURCE_CUDA, SOURCE_PLAIN, TunedEntry

__all__ = ["CandidateTiming", "candidates", "default_params", "tune_op"]

#: Timing sources :func:`tune_op` accepts.
SOURCES = ("cuda", "proxy")


@dataclasses.dataclass(frozen=True)
class CandidateTiming:
    """One timed candidate: its params, median time, and any note."""

    params: Mapping[str, int]
    median_us: float
    note: str = ""


def default_params(op) -> Dict[str, int]:
    """The family's static tile defaults (what untuned dispatch uses)."""
    return {k: int(v) for k, v in dict(op.tile_defaults).items()}


def candidates(op, budget: Optional[int] = None) -> List[Dict[str, int]]:
    """The candidate grid: cross product of ``op.tile_space`` values.

    The static default config always comes first (its timing anchors the
    tuned-vs-default delta), and *budget* caps the total number of
    candidates -- the default is never the one dropped.
    """
    space = dict(op.tile_space)
    default = default_params(op)
    grid = [default]
    if space:
        names = sorted(space)
        for combo in itertools.product(*(space[n] for n in names)):
            cfg = {n: int(v) for n, v in zip(names, combo)}
            if cfg != default and cfg not in grid:
                grid.append(cfg)
    if budget is not None:
        grid = grid[:max(1, int(budget))]
    return grid


def _default_timer() -> Callable:
    """The canonical median+IQR timer (``repro_torch.core.timing.time_fn``,
    which the sweep re-exports), so tuned-vs-default deltas and
    ``us_per_call`` carry the same statistics."""
    from ..core.timing import time_fn
    return time_fn


def _time_candidate(op, engine: str, params: Mapping[str, int],
                    args: tuple, kwargs: dict, *, source: str,
                    backend: str, timer: Callable) -> float:
    if source == "proxy":
        if op.tune_proxy is None:
            raise ValueError(f"kernel {op.name!r} declares no tune_proxy; "
                             "cannot time candidates off-hardware")
        fn = lambda: op.tune_proxy(params, *args, **kwargs)  # noqa: E731
    else:
        engine_fn = op.engines[engine]
        fn = lambda: engine_fn(*args, backend=backend,  # noqa: E731
                               **{**kwargs, **params})
    return float(timer(fn).median_us)


def tune_op(op, *, engine: str, dtype: str = "float32",
            size: Optional[int] = None, budget: int = 8,
            source: str = "cuda", backend: str = "cuda",
            hw_model: str = "", seed: int = 0,
            timer: Optional[Callable] = None,
            verbose: Optional[Callable[[str], Any]] = None,
            inputs: Optional[Tuple[tuple, dict]] = None,
            ) -> Optional[TunedEntry]:
    """Search one (kernel, engine, dtype) and return the winning entry.

    Returns None when the family declares no tunable space.  *size*
    defaults to the family's largest ``bench_sizes`` entry (the
    reference's choice; on the card those sizes fit in the L2, so callers
    that want HBM-bound winners pass a STREAM size).  Inputs are built on
    the card for ``backend="cuda"``, on the CPU for ``"plain"``.
    *inputs* ``(args, kwargs)`` replaces ``make_inputs`` for shapes that
    ``size`` alone does not describe (a 3-D stencil, a decode step with
    more heads); *size* then names them in the entry and is required.
    """
    if source not in SOURCES:
        raise ValueError(f"unknown timing source {source!r}; expected "
                         f"one of {SOURCES}")
    if backend not in ("cuda", "plain"):
        raise ValueError(f"unknown backend {backend!r}; expected 'cuda' "
                         "or 'plain'")
    if not op.tile_space:
        return None
    if inputs is not None and size is None:
        raise ValueError("inputs= needs size= to name them in the entry")
    if size is None:
        if not op.bench_sizes:
            raise ValueError(f"kernel {op.name!r} has no bench_sizes; "
                             "pass size= explicitly")
        size = max(op.bench_sizes)
    timer = timer or _default_timer()
    if inputs is None:
        rng = np.random.default_rng(seed)
        device = "cuda" if backend == "cuda" else "cpu"
        args, kwargs = op.make_inputs(rng, size, dtype, device)
    else:
        args, kwargs = inputs

    timings: List[CandidateTiming] = []
    for params in candidates(op, budget):
        try:
            us = _time_candidate(op, engine, params, args, kwargs,
                                 source=source, backend=backend,
                                 timer=timer)
        except Exception as exc:  # invalid corner of the space: skip
            timings.append(CandidateTiming(params, float("inf"),
                                           f"skipped: {exc}"))
            if verbose:
                verbose(f"{op.name}/{engine}/{dtype} {params}: "
                        f"skipped ({exc})")
            continue
        timings.append(CandidateTiming(params, us))
        if verbose:
            verbose(f"{op.name}/{engine}/{dtype} {params}: {us:.1f} us")

    ok = [t for t in timings if t.median_us != float("inf")]
    if not ok:
        raise RuntimeError(
            f"{op.name}/{engine}/{dtype}: every candidate failed "
            f"({[t.note for t in timings]})")
    best = min(ok, key=lambda t: t.median_us)
    default_us = ok[0].median_us if ok[0].params == default_params(op) \
        else best.median_us
    return TunedEntry(
        kernel=op.name, engine=engine, dtype=dtype,
        hw_model=hw_model, params=best.params, best_us=best.median_us,
        default_us=default_us, size=int(size),
        source=SOURCE_CUDA if backend == "cuda" else SOURCE_PLAIN,
        budget=int(budget))
