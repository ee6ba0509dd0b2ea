"""Versioned ``tuned.json`` cache of winning tile configurations.

One :class:`TunedEntry` per (kernel family, engine, dtype, hardware
model, shard shape) -- the granularity at which a tile choice is
transferable: array *values* never move a kernel on the roofline (paper
§2.3) and the sweep sizes share one bandwidth regime, so the cache does
not key on size.  It *does* key on the shard shape (``"full"`` for an
unsharded launch, ``"2-way"`` etc. for a mesh-split one): a shard sees
1/N of the rows, so its winning tile is generally narrower.

File format (schema 2), the reference package's::

    {
      "schema": 2,
      "fingerprint": {"torch": ..., "cuda": ..., "numpy": ...,
                      "device": ..., "python": ...},
      "entries": [
        {"kernel": "stencil", "engine": "vector", "dtype": "float32",
         "hw_model": "H100-SXM5", "params": {"block_rows": 256},
         "best_us": ..., "default_us": ..., "size": 8192,
         "source": "cuda", "budget": 8, "shard_shape": "full"}, ...
      ]
    }

A file written by either package loads in the other.  Schema-1 files (no
``shard_shape``) still load, every entry as a full-width winner, with a
deprecation :class:`TuningCacheWarning`.

Load rules (dispatch must never crash because a cache file is bad):
corrupted JSON, an unknown schema, or a malformed entry list degrade to
an *empty* cache with a :class:`TuningCacheWarning`.  A fingerprint from
another environment also warns but is kept: a stale tile is a
performance hint, not a correctness hazard, because every consumer
re-validates configs against the family's ``tile_space``.  Entries are
keyed by ``hw_model``, so a TPU-v5e cache loads and never answers an
H100 lookup.

Merge semantics (``TuningCache.merge``): entries on either side survive;
where both carry a key the *faster* entry (lower ``best_us``) wins, so
repeated tuning runs and persisted online winners only tighten the cache.

Sources: ``"cuda"`` entries were timed on the card's hand-written kernels
(:func:`repro_torch.tuning.tuner.tune_op` with ``backend="cuda"``).
``"plain"`` timings are of the kernels' plain PyTorch versions on the
CPU; they say nothing about a tile, so :meth:`TuningCache.add` refuses
them, as it refuses the reference's ``"pallas-interpret"`` timings.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

__all__ = [
    "CACHE_SCHEMA", "InterpretTimingError", "TunedEntry", "TuningCache",
    "TuningCacheWarning", "env_fingerprint", "shard_shape_of",
]

#: Version of the tuned.json file format.
CACHE_SCHEMA = 2
#: The pre-shard_shape format still accepted (with a warning) on load.
LEGACY_CACHE_SCHEMA = 1

#: The reference's tag for its pure-XLA tiling proxy timings.
SOURCE_PROXY = "xla-proxy"
#: Winners measured by the online bandit from live batch compute times
#: (:mod:`repro_torch.tuning.online`).
SOURCE_ONLINE = "online"
#: Timings of the hand-written CUDA kernels on the card.
SOURCE_CUDA = "cuda"
#: Timings of the kernels' plain PyTorch versions on the CPU.  Never
#: persisted: a plain version has no tile, so a choice based on it is noise.
SOURCE_PLAIN = "plain"
#: The reference's interpret-mode Pallas timings.  Never persisted either.
SOURCE_PALLAS_INTERPRET = "pallas-interpret"
#: Sources :meth:`TuningCache.add` refuses.
REFUSED_SOURCES = (SOURCE_PLAIN, SOURCE_PALLAS_INTERPRET)

#: Shard shape of an unsharded (single-device, full-width) launch.
FULL_SHARD_SHAPE = "full"

Key = Tuple[str, str, str, str, str]
#: (kernel, engine, dtype, hw_model, shard_shape)


def shard_shape_of(num_shards: int) -> str:
    """The cache's shard-shape label for an *num_shards*-way launch:
    ``"full"`` for 1 (or fewer) shards, ``"<N>-way"`` otherwise."""
    n = int(num_shards)
    return FULL_SHARD_SHAPE if n <= 1 else f"{n}-way"


class TuningCacheWarning(UserWarning):
    """A tuned.json could not be used (corrupt, wrong schema, stale env)."""


class InterpretTimingError(RuntimeError):
    """Refusal to persist tile choices from timings that measure no tile
    (the plain versions on the CPU, interpret-mode Pallas)."""


def env_fingerprint() -> Dict[str, str]:
    """The environment a cache's timings were taken in: torch, its CUDA,
    numpy, the device's name (the card's, else ``"cpu"``) and Python."""
    import platform

    import numpy
    import torch

    on_card = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "numpy": numpy.__version__,
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "python": platform.python_version(),
    }


@dataclasses.dataclass(frozen=True)
class TunedEntry:
    """One winning tile configuration for (kernel, engine, dtype, hw,
    shard shape).

    ``params`` are the keyword arguments the family's engine entry points
    accept (e.g. ``{"block_rows": 64}``); ``best_us`` / ``default_us`` are
    the tuner's median times for the winner and for the static default,
    so consumers can render the tuned-vs-default delta without
    re-measuring.  ``shard_shape`` scopes the entry to a launch width.
    """

    kernel: str
    engine: str
    dtype: str
    hw_model: str
    params: Mapping[str, int]
    best_us: float
    default_us: float
    size: int          # input size the search timed
    source: str = SOURCE_CUDA
    budget: int = 0    # candidate budget the search ran under
    shard_shape: str = FULL_SHARD_SHAPE

    @property
    def key(self) -> Key:
        """The cache key (kernel, engine, dtype, hw_model, shard_shape)."""
        return (self.kernel, self.engine, self.dtype, self.hw_model,
                self.shard_shape)

    @property
    def speedup(self) -> float:
        """default_us / best_us -- how much the tuned tile gains."""
        return self.default_us / self.best_us if self.best_us > 0 else 1.0

    def to_json(self) -> Dict[str, Any]:
        """The entry as a plain JSON-serializable dict."""
        d = dataclasses.asdict(self)
        d["params"] = {k: int(v) for k, v in sorted(self.params.items())}
        return d

    @classmethod
    def from_json(cls, raw: Mapping[str, Any]) -> "TunedEntry":
        """Parse one entry dict; raises on missing fields / bad types.

        A missing ``source`` reads as the reference's ``"xla-proxy"``
        (its files predate the tag's default moving), a missing
        ``shard_shape`` as ``"full"`` (schema 1).
        """
        return cls(
            kernel=str(raw["kernel"]), engine=str(raw["engine"]),
            dtype=str(raw["dtype"]), hw_model=str(raw["hw_model"]),
            params={str(k): int(v)
                    for k, v in dict(raw["params"]).items()},
            best_us=float(raw["best_us"]),
            default_us=float(raw["default_us"]),
            size=int(raw["size"]),
            source=str(raw.get("source", SOURCE_PROXY)),
            budget=int(raw.get("budget", 0)),
            shard_shape=str(raw.get("shard_shape", FULL_SHARD_SHAPE)),
        )


class TuningCache:
    """In-memory tuned-tile store with load/save/merge semantics."""

    def __init__(self, entries: Iterable[TunedEntry] = (),
                 fingerprint: Optional[Mapping[str, str]] = None):
        self._entries: Dict[Key, TunedEntry] = {}
        self.fingerprint = dict(fingerprint) if fingerprint else {}
        for e in entries:
            self.add(e)

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self):
        return iter(sorted(self._entries.values(), key=lambda e: e.key))

    def add(self, entry: TunedEntry) -> TunedEntry:
        """Insert one entry (last write wins for its key).

        Raises :class:`InterpretTimingError` for ``"plain"`` and
        ``"pallas-interpret"`` entries: their times measure no tile.
        """
        if entry.source in REFUSED_SOURCES:
            raise InterpretTimingError(
                f"{'/'.join(entry.key)}: timings came from "
                f"{entry.source!r}, which times no tile (the plain "
                "versions on the CPU, or the Pallas emulator); refusing to "
                "cache this tile choice. Time the hand-written kernels on "
                "the card (backend='cuda').")
        self._entries[entry.key] = entry
        return entry

    def lookup(self, kernel: str, engine: str, dtype: str, hw_model: str,
               shard_shape: str = FULL_SHARD_SHAPE
               ) -> Optional[TunedEntry]:
        """The winning entry for this key, or None (use static defaults).

        Exact on every field: a sharded launch never inherits the
        full-width tile, and another card's (or a TPU's) entry never
        answers this card.
        """
        return self._entries.get(
            (kernel, engine, dtype, hw_model, shard_shape))

    def merge(self, other: "TuningCache") -> "TuningCache":
        """Fold *other* into self: faster ``best_us`` wins per key.

        Entries only one side knows survive unconditionally, so repeated
        tuning runs with partial coverage accumulate.
        """
        for entry in other:
            mine = self._entries.get(entry.key)
            if mine is None or entry.best_us < mine.best_us:
                self._entries[entry.key] = entry
        if other.fingerprint:
            self.fingerprint = dict(other.fingerprint)
        return self

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the cache as schema-2 tuned.json (merging is the caller's
        job: see ``load_or_warn`` + ``merge``)."""
        payload = {
            "schema": CACHE_SCHEMA,
            "fingerprint": self.fingerprint or env_fingerprint(),
            "entries": [e.to_json() for e in self],
        }
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        """Strict load: raises ValueError/OSError on any problem.

        Schema-1 files are migrated in memory (every entry a full-width
        winner) with a deprecation :class:`TuningCacheWarning`.
        """
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict):
            raise ValueError(f"{path}: expected an object, got "
                             f"{type(payload).__name__}")
        schema = payload.get("schema")
        if schema not in (CACHE_SCHEMA, LEGACY_CACHE_SCHEMA):
            raise ValueError(f"{path}: unsupported tuned.json schema "
                             f"{schema!r} (this build reads "
                             f"{LEGACY_CACHE_SCHEMA} and {CACHE_SCHEMA})")
        if schema == LEGACY_CACHE_SCHEMA:
            warnings.warn(
                f"tuned cache {path!r} is schema {LEGACY_CACHE_SCHEMA} "
                "(no shard_shape); loading its entries as full-width "
                f"winners -- re-save to upgrade to schema {CACHE_SCHEMA}",
                TuningCacheWarning, stacklevel=2)
        raw_entries = payload.get("entries")
        if not isinstance(raw_entries, list):
            raise ValueError(f"{path}: missing its 'entries' list")
        entries = [TunedEntry.from_json(r) for r in raw_entries]
        return cls(entries, fingerprint=payload.get("fingerprint"))

    @classmethod
    def load_or_warn(cls, path: str) -> "TuningCache":
        """Forgiving load for the dispatch path: never raises.

        A missing, corrupted, or version-mismatched file degrades to an
        empty cache with a :class:`TuningCacheWarning`.  A fingerprint
        from another environment also warns, and the entries are kept.
        """
        try:
            cache = cls.load(path)
        except (OSError, ValueError, KeyError, TypeError,
                InterpretTimingError) as exc:
            warnings.warn(
                f"ignoring tuned cache {path!r} ({exc}); dispatch falls "
                "back to static tile defaults", TuningCacheWarning,
                stacklevel=2)
            return cls()
        current = env_fingerprint()
        stale = {k: (v, current.get(k)) for k, v in
                 cache.fingerprint.items()
                 if k in current and current[k] != v}
        if stale:
            warnings.warn(
                f"tuned cache {path!r} was recorded under a different "
                f"environment ({stale}); its tile choices are advisory",
                TuningCacheWarning, stacklevel=2)
        return cache
