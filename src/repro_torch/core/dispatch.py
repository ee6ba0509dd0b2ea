"""Engine-dispatch runtime: one place that turns the paper's decision
framework into kernel launches.

  * ``Dispatcher`` -- resolves ``engine='auto'|'vpu'|'mxu'`` against the
    advisor, memoizing one ``Advice`` per (kernel, shape, dtype,
    hardware) so steady-state dispatch is a dict hit, not a roofline
    re-derivation.
  * ``TuningPolicy`` -- consults a versioned ``tuned.json`` cache
    (``repro_torch.tuning.cache``) for the winning tile configuration per
    (kernel, engine, dtype, hardware model, shard shape) before falling
    back to the static tile defaults.
  * ``Dispatcher.set_mesh`` -- the shard width Advice is planned for:
    above 1, every memoized Advice carries the ``ShardSpec`` of
    ``repro_torch.sharding.plan`` and tile lookups read the per-shard
    entries.  The mode labels how the shards run: one after another on
    one device (``"virtual"``, ``repro_torch.sharding.ShardedExecutor``)
    or side by side on N ranks (``"mesh"``, ``MeshExecutor``).
  * ``elementwise_call`` -- the shared wrapper for same-shape
    elementwise kernels (SCALE, STREAM Triad, AXPY): one hand-written
    CUDA kernel per engine serves all three families.

``backend`` picks where a call runs: ``"cuda"`` (the default) launches
the hand-written kernel and needs tensors on the card; ``"plain"`` runs
the kernel's plain PyTorch version and needs tensors on the CPU.  A
mismatch raises; nothing falls back.

When the :mod:`repro_torch.obs` tracer is enabled, ``Dispatcher.run``
wraps each call in a ``dispatch`` span with a nested ``launch`` span that
carries the Eq. 2/3/4 roofline counters; on the card the launch is timed
by a CUDA event pair that the outermost capture resolves, so nothing
waits for the card.  While a ``torch.profiler`` records, the two spans
are also its ranges ``dispatch.<kernel>`` and ``launch.<kernel>.<engine>``.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
import warnings
from typing import Any, Callable, Dict, Hashable, Mapping, Optional

import torch

from ..obs.counters import roofline_sample
from ..obs.log import LOG
from ..obs.trace import TRACER, profiling
from .advisor import DEFAULT_ADVISOR, Advice, EngineAdvisor
from .intensity import KernelTraits

__all__ = [
    "BACKENDS", "DEFAULT_DISPATCHER", "Dispatcher", "MESH_MODES", "TUNED_CACHE_ENV",
    "TuningPolicy", "check_backend", "default_cache_key", "dtype_name",
    "elementwise_call", "normalize_engine", "ELEMENTWISE_BLOCK_ROWS",
    "ELEMENTWISE_LANES",
]

BACKENDS = ("cuda", "plain")

#: Environment variable naming a tuned.json for the default policy (the
#: port's own name, so the reference's ``REPRO_TUNED_JSON`` -- a TPU
#: cache -- never reaches it).
TUNED_CACHE_ENV = "REPRO_TORCH_TUNED_JSON"

_ENGINE_ALIASES = {
    "mxu": "matrix", "matrix": "matrix",
    "vpu": "vector", "vector": "vector",
}


def normalize_engine(engine: str) -> Optional[str]:
    """'auto' -> None (advisor decides); 'mxu'/'vpu' aliases -> canonical.

    The canonical names follow the paper's engine taxonomy (§2.1):
    'matrix' (tensor core) and 'vector' (CUDA core).
    """
    if engine == "auto":
        return None
    try:
        return _ENGINE_ALIASES[engine]
    except KeyError:
        raise ValueError(
            f"unknown engine {engine!r}; expected 'auto', "
            f"{sorted(set(_ENGINE_ALIASES))}") from None


def dtype_name(dtype: Any) -> str:
    """'float32' / 'bfloat16' for torch and numpy dtypes alike."""
    return str(dtype).replace("torch.", "")


def check_backend(backend: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies where ``backend`` runs.

    ``"cuda"`` launches a hand-written kernel and takes card tensors
    only; ``"plain"`` is the CPU path and takes CPU tensors only.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    want_cuda = backend == "cuda"
    for t in tensors:
        if t.is_cuda != want_cuda:
            raise ValueError(
                f"backend={backend!r} needs tensors on "
                f"{'the card' if want_cuda else 'the CPU'}, got one on "
                f"{t.device}")


def _probe(x: Any) -> Hashable:
    """Reduce one call argument to a hashable dispatch-cache component.

    Arrays contribute (shape, dtype name) -- their values never change
    the roofline position.  Unhashable dataclasses such as BlockEll
    recurse field-wise.
    """
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return ("arr", tuple(x.shape), dtype_name(x.dtype))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        try:
            hash(x)
            return x
        except TypeError:
            return (type(x).__name__,) + tuple(
                _probe(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_probe(e) for e in x)
    if isinstance(x, dict):
        return tuple((k, _probe(v)) for k, v in sorted(x.items()))
    try:
        hash(x)
        return x
    except TypeError:
        return ("repr", repr(x))


def default_cache_key(*args, **kwargs) -> Hashable:
    """Shape/dtype cache key for Advice memoization.

    Two calls share a key iff they share a roofline position (paper
    §2.3): array values never move a kernel on the roofline, only
    shapes, dtypes, and static parameters do.
    """
    return (_probe(args), _probe(kwargs))


def _dtype_of(args: tuple, kwargs: dict) -> Optional[str]:
    """The dtype name of the first array-ish call argument, if any."""
    for x in list(args) + list(kwargs.values()):
        if hasattr(x, "dtype") and hasattr(x, "shape"):
            return dtype_name(x.dtype)
    return None


class TuningPolicy:
    """Tile-configuration lookups against a ``tuned.json`` cache.

    The policy layer between the dispatcher and
    ``repro_torch.tuning.cache.TuningCache``: ``lookup`` returns the
    winning entry for (kernel, engine, dtype, hw model, shard shape) or
    None, in which case callers use the static defaults.  The default
    policy lazily loads the path named by :data:`TUNED_CACHE_ENV`
    (forgivingly: a corrupt or version-mismatched file warns and degrades
    to the static defaults rather than breaking dispatch).
    """

    def __init__(self, cache=None):
        self._cache = cache
        self._resolved = cache is not None

    @property
    def cache(self):
        """The backing TuningCache (lazy-loaded), or None if empty."""
        if not self._resolved:
            path = os.environ.get(TUNED_CACHE_ENV)
            if path:
                from ..tuning.cache import TuningCache
                self._cache = TuningCache.load_or_warn(path)
            self._resolved = True
        return self._cache

    def load(self, path: str) -> None:
        """Point the policy at a tuned.json (forgiving load, see above)."""
        from ..tuning.cache import TuningCache
        self._cache = TuningCache.load_or_warn(path)
        self._resolved = True

    def set_cache(self, cache) -> None:
        """Install an in-memory TuningCache (None = static defaults)."""
        self._cache = cache
        self._resolved = True

    def lookup(self, kernel: str, engine: str, dtype: Optional[str],
               hw_model: str, num_shards: int = 1):
        """The TunedEntry for this key, or None (use static defaults).

        ``num_shards`` scopes the lookup to the launch width via the
        cache's ``shard_shape`` key component: a sharded launch only ever
        sees per-shard winners, never the full-width tile.
        """
        cache = self.cache
        if cache is None or dtype is None:
            return None
        from ..tuning.cache import shard_shape_of
        return cache.lookup(kernel, engine, dtype, hw_model,
                            shard_shape_of(num_shards))


#: How sharded calls execute: ``"virtual"`` (serial launches on one
#: device, modelled N-way clock) or ``"mesh"`` (N ranks, measured).
MESH_MODES = ("virtual", "mesh")


def _check_mesh_mode(mode: str) -> str:
    if mode not in MESH_MODES:
        raise ValueError(
            f"mesh mode must be one of {MESH_MODES}, got {mode!r}")
    return mode


class Dispatcher:
    """Advisor-backed engine router with a memoized Advice cache.

    Implements the paper's §6 takeaway as a runtime policy: classify by
    intensity vs. machine balance (Eq. 1/2/4), send memory-bound work to
    the vector engine, and memoize the resulting Advice.
    """

    def __init__(self, advisor: Optional[EngineAdvisor] = None,
                 tuning: Optional[TuningPolicy] = None,
                 mesh_shards: int = 1, mesh_mode: str = "virtual"):
        self.advisor = advisor if advisor is not None else DEFAULT_ADVISOR
        self.tuning = tuning if tuning is not None else TuningPolicy()
        self._mesh_shards = max(1, int(mesh_shards))
        self._mesh_mode = _check_mesh_mode(mesh_mode)
        self._cache: Dict[Hashable, Advice] = {}
        self._hits = 0
        self._misses = 0

    @property
    def hw(self):
        """The advisor's HardwareSpec (paper Table 1 platform model)."""
        return self.advisor.hw

    @property
    def mesh_shards(self) -> int:
        """How many shards Advice is planned for (1 = no mesh)."""
        return self._mesh_shards

    @property
    def mesh_mode(self) -> str:
        """How sharded calls execute (:data:`MESH_MODES`)."""
        return self._mesh_mode

    def set_mesh(self, num_shards: int, mode: str = "virtual") -> None:
        """Configure the shard width (and execution mode) Advice plans for.

        With ``num_shards > 1`` every memoized Advice carries the
        ``ShardSpec`` the sharding layer (``repro_torch.sharding.plan``)
        derives for its call -- the paper's §6 decision is then a
        per-shard statement, which Eq. 2's intensity invariance under
        data-parallel splitting keeps identical to the per-device one.
        ``mode`` stamps how those shards execute: ``"virtual"`` (serial
        launches on one device, modelled N-way clock) or ``"mesh"`` (N
        ranks, measured); it labels the advice and does not change it.
        The Advice cache embeds both, so changing either drops it.
        """
        num_shards = int(num_shards)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        mode = _check_mesh_mode(mode)
        if num_shards != self._mesh_shards or mode != self._mesh_mode:
            self._mesh_shards = num_shards
            self._mesh_mode = mode
            self.cache_clear()

    def _memoized(self, key: Hashable,
                  make: Callable[[], Advice]) -> Advice:
        advice = self._cache.get(key)
        if advice is None:
            self._misses += 1
            advice = self._cache[key] = make()
        else:
            self._hits += 1
        return advice

    def advise(self, op, *args, **kwargs) -> Advice:
        """Memoized Advice (paper §6 decision) for one op + call arguments.

        The cache key is (kernel, hardware, shapes/dtypes/static params);
        the op's ``KernelTraits`` factory (W flops, Q bytes per Eq. 2)
        only runs on a miss.  The returned Advice also records the tile
        config the TuningPolicy would apply for the chosen engine
        (``tile_config=None`` means static defaults), so records can say
        *which* tiles produced a number.
        """
        key_fn = op.cache_key or default_cache_key
        key = (op.name, self.hw.name, self._mesh_shards,
               key_fn(*args, **kwargs))

        def make() -> Advice:
            advice = self.advisor.advise(op.traits(*args, **kwargs))
            entry = self.tuning.lookup(op.name, advice.engine,
                                       _dtype_of(args, kwargs),
                                       self.hw.name,
                                       num_shards=self._mesh_shards)
            if entry is not None:
                advice = dataclasses.replace(
                    advice,
                    tile_config=tuple(sorted(entry.params.items())))
            if self._mesh_shards > 1:
                # planned once per (kernel, shape, mesh) and memoized
                # with the engine decision: steady-state sharded dispatch
                # stays a dict hit
                from ..sharding.plan import spec_for
                advice = dataclasses.replace(
                    advice,
                    shard_spec=spec_for(op, self._mesh_shards,
                                        *args, **kwargs),
                    exec_mode=self._mesh_mode)
            return advice

        return self._memoized(key, make)

    def advise_traits(self, traits: KernelTraits) -> Advice:
        """Memoized Advice (paper §6) for hand-built Eq. 2 traits."""
        key = (traits.name, self.hw.name, traits.work_flops,
               traits.traffic_bytes)
        return self._memoized(key, lambda: self.advisor.advise(traits))

    def resolve(self, op, *args, engine: str = "auto", **kwargs) -> str:
        """Resolve an engine flag to 'vector'|'matrix' for this call.

        'auto' defers to the advisor (paper §6: memory-bound -> vector);
        explicit flags are honored verbatim.
        """
        forced = normalize_engine(engine)
        if forced is not None:
            return forced
        return self.advise(op, *args, **kwargs).engine

    def tile_params(self, op, eng: str, *args,
                    **kwargs) -> Optional[Dict[str, int]]:
        """The tuned tile params this call would use, or None (defaults).

        Consults the TuningPolicy with the op's name, the resolved
        engine, the call's dtype, the advisor's hardware model and the
        current mesh width -- the granularity winners are cached at.
        """
        entry = self.tuning.lookup(op.name, eng, _dtype_of(args, kwargs),
                                   self.hw.name,
                                   num_shards=self._mesh_shards)
        return dict(entry.params) if entry is not None else None

    def run(self, op, *args, engine: str = "auto", backend: str = "cuda",
            tile_config: Optional[Mapping[str, int]] = None, **kwargs):
        """Advisor-route (paper §6), tile-tune, and launch one op.

        Tile precedence: an explicit ``tile_config`` overrides everything
        (including per-call kwargs it collides with); a TuningPolicy hit
        overrides the static defaults but *not* explicitly passed kwargs;
        otherwise the family's static defaults apply.  An explicit config
        naming a parameter outside the op's ``tile_space`` raises; a
        cache entry doing so warns and drops the unknown names (a stale
        cache is advisory, never a crash).

        When the :mod:`repro_torch.obs` tracer is enabled, the call is
        wrapped in a ``dispatch`` span (routing) with a nested ``launch``
        span around the engine body, which carries the roofline counters
        for the measured time: on the card a CUDA event pair's, resolved
        when the outermost capture closes (nothing waits for the card),
        on the CPU the body's.  While a profiler records, the two spans
        are its ranges ``dispatch.<kernel>`` and
        ``launch.<kernel>.<engine>``.  Untraced and unprofiled, the call
        costs one branch.
        """
        if not (TRACER.enabled or profiling()):
            return self._run(op, *args, engine=engine, backend=backend,
                             tile_config=tile_config, **kwargs)
        with TRACER.span("dispatch", layer="dispatch",
                         label=f"dispatch.{op.name}",
                         kernel=op.name) as span_attrs:
            return self._run(op, *args, engine=engine, backend=backend,
                             tile_config=tile_config,
                             _span_attrs=span_attrs, **kwargs)

    def _run(self, op, *args, engine: str, backend: str,
             tile_config: Optional[Mapping[str, int]],
             _span_attrs: Optional[Dict[str, Any]] = None, **kwargs):
        semantic = {k: v for k, v in kwargs.items()
                    if k not in op.tile_space}
        eng = self.resolve(op, *args, engine=engine, **semantic)
        fn = op.engines.get(eng)
        if fn is None:
            raise ValueError(
                f"kernel {op.name!r} has no {eng!r} variant "
                f"(has {sorted(op.engines)})")
        explicit = tile_config is not None
        cfg = dict(tile_config) if explicit else \
            self.tile_params(op, eng, *args, **semantic)
        if cfg:
            unknown = sorted(set(cfg) - set(op.tile_space))
            if unknown and explicit:
                raise ValueError(
                    f"kernel {op.name!r} does not accept tile "
                    f"parameter(s) {unknown}; its tile space is "
                    f"{sorted(op.tile_space) or 'empty'}")
            if unknown:
                from ..tuning.cache import TuningCacheWarning
                warnings.warn(
                    f"tuned config for {op.name}/{eng} names unknown "
                    f"tile parameter(s) {unknown}; ignoring them "
                    f"(tile space: {sorted(op.tile_space) or 'empty'})",
                    TuningCacheWarning, stacklevel=2)
                cfg = {k: v for k, v in cfg.items() if k in op.tile_space}
            if explicit:
                kwargs = {**kwargs, **cfg}
            else:  # tuned values fill gaps; a None kwarg is a gap too
                kwargs = {**kwargs, **{k: v for k, v in cfg.items()
                                       if kwargs.get(k) is None}}
        if _span_attrs is None:
            return fn(*args, backend=backend, **kwargs)
        dtype = _dtype_of(args, kwargs) or ""
        _span_attrs.update(engine=eng, dtype=dtype)
        with TRACER.span("launch", layer="dispatch",
                         label=f"launch.{op.name}.{eng}", kernel=op.name,
                         engine=eng, dtype=dtype) as launch_attrs:
            if not TRACER.enabled:       # a profiler's range alone
                return fn(*args, backend=backend, **kwargs)
            counters = self._counters(op, eng, dtype, args, semantic)
            if backend == "cuda":
                stream = torch.cuda.current_stream()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                out = fn(*args, backend=backend, **kwargs)
                end.record(stream)
                if counters is not None:
                    TRACER.defer(start, end, counters)
                return out
            t0 = time.perf_counter()
            out = fn(*args, backend=backend, **kwargs)
            if counters is not None:
                launch_attrs.update(
                    counters((time.perf_counter() - t0) * 1e6))
        return out

    def _counters(self, op, eng: str, dtype: str, args: tuple,
                  semantic: Dict[str, Any]
                  ) -> Optional[Callable[[float], Dict[str, Any]]]:
        """The launch span's roofline counters as a function of the
        measured microseconds, from this call's Eq. 2 traits (taken now,
        so no argument is kept alive), or None without traits."""
        try:
            traits = op.traits(*args, **semantic)
        except (TypeError, ValueError) as e:
            LOG.debug("roofline counters unavailable", kernel=op.name,
                      engine=eng, error=str(e))
            return None
        return functools.partial(_roofline_attrs, traits, self.hw, eng,
                                 dtype)

    def load_tuned(self, path: str) -> None:
        """Adopt a tuned.json and drop the memoized Advice, which embeds
        tile configs."""
        self.tuning.load(path)
        self.cache_clear()

    def set_tuning_cache(self, cache) -> None:
        """Install an in-memory TuningCache (None = static defaults)."""
        self.tuning.set_cache(cache)
        self.cache_clear()

    def cache_info(self) -> Dict[str, int]:
        """Advice-cache statistics: {size, hits, misses}."""
        return {"size": len(self._cache), "hits": self._hits,
                "misses": self._misses}

    def cache_clear(self) -> None:
        """Drop all memoized Advice (e.g. after swapping hardware specs)."""
        self._cache.clear()
        self._hits = self._misses = 0


def _roofline_attrs(traits: KernelTraits, hw, eng: str, dtype: str,
                    measured_us: float) -> Dict[str, Any]:
    """A launch span's roofline counters (``RooflineSample.as_attrs``),
    or none where the sample cannot be taken."""
    try:
        return roofline_sample(traits, hw, eng, dtype,
                               measured_us).as_attrs()
    except (TypeError, ValueError) as e:
        LOG.debug("roofline counters unavailable", kernel=traits.name,
                  engine=eng, error=str(e))
        return {}


DEFAULT_DISPATCHER = Dispatcher()


# --------------------------------------------------------------------------
# shared elementwise wrapper
# --------------------------------------------------------------------------

ELEMENTWISE_LANES = 1024      # tile width (elements) of the tile space
ELEMENTWISE_BLOCK_ROWS = 256  # tile height of the tile space


def elementwise_plain(m: torch.Tensor, q, add: Optional[torch.Tensor],
                      engine: str) -> torch.Tensor:
    """Plain PyTorch version of the elementwise kernels, same rounding.

    Vector engine: ``q * m`` with ``q`` in float32, plus ``add`` in one
    fused multiply-add (the reference's fused body), rounded once to the
    input dtype.  Matrix engine: ``q`` is first held in the input dtype
    (the scaled identity is built in that dtype), ``q * m`` is rounded to
    float32, and ``add`` is added in float32, as two float32 dots are.
    """
    dtype = m.dtype
    q32 = torch.tensor(q, dtype=torch.float32)
    if engine == "matrix":
        out = m.float() * q32.to(dtype).float().to(m.device)
        if add is not None:
            out = out + add.float()
        return out.to(dtype)
    if add is None:
        return (m.float() * q32.to(m.device)).to(dtype)
    # q*m is exact in float64; one float64 sum stands in for the FMA
    fused = m.double() * float(q32) + add.double()
    return fused.float().to(dtype)


def elementwise_call(family: str, m: torch.Tensor, q,
                     add: Optional[torch.Tensor] = None, *, engine: str,
                     backend: str = "cuda",
                     block_rows: Optional[int] = None,
                     lanes: Optional[int] = None) -> torch.Tensor:
    """``q * m (+ add)`` on the chosen engine.

    The shared launch path behind the paper's §3.1 elementwise suite:
    SCALE is ``q*b``, STREAM Triad ``q*c + b``, AXPY ``a*x + y``.
    Arrays of any same shape are read flat; the kernel handles the
    ragged tail itself, so only the output is allocated and it keeps the
    input's shape and dtype.

    The kernel gives each thread one 16-byte chunk of every array: a CTA
    of 256 threads moves 256 consecutive chunks, and the grid has one CTA
    per 256 chunks (``repro_torch.kernels._ext.elementwise_grid``), many
    waves that the card's scheduler hands out in address order.  The tile
    ``block_rows x lanes`` (``None``: the static 256 x 1024) is the TPU
    kernel's VMEM block; on Hopper it does not shape the launch (larger
    units per CTA measured slower).  It is still checked and accepted, so
    ``tile_config`` through the ``Dispatcher`` and the tuning space stay
    valid.
    """
    lanes = ELEMENTWISE_LANES if lanes is None else int(lanes)
    block_rows = (ELEMENTWISE_BLOCK_ROWS if block_rows is None
                  else int(block_rows))
    if lanes <= 0 or block_rows <= 0:
        raise ValueError(f"bad tile {block_rows}x{lanes}")
    arrays = (m,) if add is None else (m, add)
    for a in arrays[1:]:
        if a.shape != m.shape or a.dtype != m.dtype:
            raise ValueError(f"elementwise arrays disagree: "
                             f"{tuple(a.shape)}/{a.dtype} vs "
                             f"{tuple(m.shape)}/{m.dtype}")
    check_backend(backend, *arrays)
    if backend == "plain":
        return elementwise_plain(m, q, add, engine)
    from ..kernels import _ext
    return _ext.elementwise(family, m, q, add, engine=engine)
