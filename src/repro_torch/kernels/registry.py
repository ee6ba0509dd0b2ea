"""Unified kernel registry: every kernel family is one ``EngineOp``.

A family registers its vector/matrix entry points together with its
``KernelTraits`` factory, oracle, and input builder; engine routing and
Advice memoization live in ``repro_torch.core.dispatch``.

    op = registry.get("scale")
    args, kw = op.make_inputs(np.random.default_rng(0), op.test_size)
    y = op(*args, **kw)                    # engine='auto': advisor-routed
    y = op(*args, engine="mxu", **kw)      # forced tensor-core kernel
    advice = op.advice(*args, **kw)        # the memoized paper §6 decision
"""
from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Any, Callable, Dict, Hashable, Mapping, Optional, Tuple

from ..core.dispatch import DEFAULT_DISPATCHER
from ..core.intensity import KernelTraits

__all__ = ["EngineOp", "all_ops", "discover", "get", "names", "register"]


@dataclasses.dataclass(frozen=True)
class EngineOp:
    """One kernel family: per-engine entry points + metadata.

    The unit of the paper's §3 workload study: each family ships both a
    vector-engine (CUDA core) and a matrix-engine (tensor core) kernel
    so the §6 decision framework has a real choice to make.  ``engines``
    map 'vector'/'matrix' to ``fn(*args, backend=..., **kw)``.
    """

    name: str
    traits: Callable[..., KernelTraits]
    engines: Mapping[str, Callable[..., Any]]
    reference: Callable[..., Any]
    # (rng, size, dtype, device) -> (args, kwargs) accepted by
    # traits/engines/reference
    make_inputs: Callable[..., Tuple[tuple, dict]]
    bench_sizes: Tuple[int, ...] = ()
    dtypes: Tuple[str, ...] = ("float32",)
    test_size: int = 0
    cache_key: Optional[Callable[..., Hashable]] = None
    doc: str = ""
    # tile parameter name -> candidate values; empty = not tunable.
    tile_space: Mapping[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    tile_defaults: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    # timing stand-in for the tuner; None until the port has one
    tune_proxy: Optional[Callable[..., Any]] = None
    # how this family would split across a mesh ('data' / 'rowblock')
    shard_kind: str = "data"
    shard_halo: Optional[Callable[..., int]] = None

    def __call__(self, *args, engine: str = "auto", backend: str = "cuda",
                 tile_config: Optional[Mapping[str, int]] = None,
                 **kwargs):
        """Launch via the default dispatcher ('auto' = paper §6 routing)."""
        return DEFAULT_DISPATCHER.run(self, *args, engine=engine,
                                      backend=backend,
                                      tile_config=tile_config, **kwargs)

    def advice(self, *args, **kwargs):
        """The memoized §6 Advice (engine, boundedness, Eq. 23/24 ceiling)."""
        return DEFAULT_DISPATCHER.advise(self, *args, **kwargs)


_REGISTRY: Dict[str, EngineOp] = {}
_DISCOVERED = False


def register(op: EngineOp) -> EngineOp:
    """Register (or re-register) one kernel op (paper §3 workload)."""
    _REGISTRY[op.name] = op
    return op


def discover() -> None:
    """Import every ``repro_torch.kernels.<family>.ops`` so registrations run.

    Families are found by scanning this package's subpackages.
    """
    global _DISCOVERED
    if _DISCOVERED:
        return
    pkg = importlib.import_module(__package__)
    for mod in pkgutil.iter_modules(pkg.__path__):
        if not mod.ispkg:
            continue
        ops_module = f"{__package__}.{mod.name}.ops"
        try:
            importlib.import_module(ops_module)
        except ModuleNotFoundError as exc:
            if exc.name != ops_module:
                raise
    _DISCOVERED = True


def names() -> Tuple[str, ...]:
    """Sorted names of every registered kernel family."""
    discover()
    return tuple(sorted(_REGISTRY))


def get(name: str) -> EngineOp:
    """Look up one registered kernel family by name (KeyError if absent)."""
    discover()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no kernel {name!r} registered; have {sorted(_REGISTRY)}"
        ) from None


def all_ops() -> Tuple[EngineOp, ...]:
    """Every registered op, name-sorted."""
    discover()
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))
