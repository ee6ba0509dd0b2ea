"""Engine-dispatch runtime: one place that turns the paper's decision
framework into kernel launches.

  * ``Dispatcher`` -- resolves ``engine='auto'|'vpu'|'mxu'`` against the
    advisor, memoizing one ``Advice`` per (kernel, shape, dtype,
    hardware) so steady-state dispatch is a dict hit, not a roofline
    re-derivation.
  * ``elementwise_call`` -- the shared wrapper for same-shape
    elementwise kernels (SCALE, STREAM Triad, AXPY): one hand-written
    CUDA kernel per engine serves all three families.

``backend`` picks where a call runs: ``"cuda"`` (the default) launches
the hand-written kernel and needs tensors on the card; ``"plain"`` runs
the kernel's plain PyTorch version and needs tensors on the CPU.  A
mismatch raises; nothing falls back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, Mapping, Optional

import torch

from .advisor import DEFAULT_ADVISOR, Advice, EngineAdvisor
from .intensity import KernelTraits

__all__ = [
    "BACKENDS", "DEFAULT_DISPATCHER", "Dispatcher", "check_backend",
    "default_cache_key", "dtype_name", "elementwise_call",
    "normalize_engine", "ELEMENTWISE_BLOCK_ROWS", "ELEMENTWISE_LANES",
]

BACKENDS = ("cuda", "plain")

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


class Dispatcher:
    """Advisor-backed engine router with a memoized Advice cache.

    Implements the paper's §6 takeaway as a runtime policy: classify by
    intensity vs. machine balance (Eq. 1/2/4), send memory-bound work to
    the vector engine, and memoize the resulting Advice.
    """

    def __init__(self, advisor: Optional[EngineAdvisor] = None):
        self.advisor = advisor if advisor is not None else DEFAULT_ADVISOR
        self._cache: Dict[Hashable, Advice] = {}
        self._hits = 0
        self._misses = 0

    @property
    def hw(self):
        """The advisor's HardwareSpec (paper Table 1 platform model)."""
        return self.advisor.hw

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
        only runs on a miss.  ``tile_config`` stays None: the port has
        no tuning cache yet.
        """
        key_fn = op.cache_key or default_cache_key
        key = (op.name, self.hw.name, key_fn(*args, **kwargs))
        return self._memoized(
            key, lambda: self.advisor.advise(op.traits(*args, **kwargs)))

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
        """Tuned tile params for this call: always None (static defaults)
        until the port has a tuning cache."""
        del op, eng, args, kwargs
        return None

    def run(self, op, *args, engine: str = "auto", backend: str = "cuda",
            tile_config: Optional[Mapping[str, int]] = None, **kwargs):
        """Advisor-route (paper §6) and launch one op.

        An explicit ``tile_config`` overrides per-call kwargs it collides
        with; its keys are validated against the op's ``tile_space``.
        """
        semantic = {k: v for k, v in kwargs.items()
                    if k not in op.tile_space}
        eng = self.resolve(op, *args, engine=engine, **semantic)
        fn = op.engines.get(eng)
        if fn is None:
            raise ValueError(
                f"kernel {op.name!r} has no {eng!r} variant "
                f"(has {sorted(op.engines)})")
        if tile_config is not None:
            cfg = dict(tile_config)
            unknown = sorted(set(cfg) - set(op.tile_space))
            if unknown:
                raise ValueError(
                    f"kernel {op.name!r} does not accept tile "
                    f"parameter(s) {unknown}; its tile space is "
                    f"{sorted(op.tile_space) or 'empty'}")
            kwargs = {**kwargs, **cfg}
        return fn(*args, backend=backend, **kwargs)

    def cache_info(self) -> Dict[str, int]:
        """Advice-cache statistics: {size, hits, misses}."""
        return {"size": len(self._cache), "hits": self._hits,
                "misses": self._misses}

    def cache_clear(self) -> None:
        """Drop all memoized Advice (e.g. after swapping hardware specs)."""
        self._cache.clear()
        self._hits = self._misses = 0


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
