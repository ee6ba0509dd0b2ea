"""Counters, gauges, and histograms with numpy percentile semantics.

Where spans answer *when and inside what*, these answer *how much and
how often*.  One process-wide :data:`REGISTRY`; instruments are created
on first use and keyed by name, so layers can record without wiring a
registry through every constructor.  ``snapshot()`` returns a plain
sorted dict for embedding in records or logs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "percentile"]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100), ``numpy.percentile`` semantics.

    Returns 0.0 for an empty sample (an idle session has no tail).
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    if len(values) == 0:
        return 0.0
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


@dataclasses.dataclass
class Counter:
    """A monotonically-increasing count (events, bytes, launches)."""

    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += n


@dataclasses.dataclass
class Gauge:
    """A last-write-wins level (queue depth, % of bound)."""

    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """A sample distribution with numpy-percentile summaries."""

    def __init__(self, name: str):
        self.name = name
        self._samples: List[float] = []

    def observe(self, v: float) -> None:
        self._samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self._samples)

    @property
    def total(self) -> float:
        return float(sum(self._samples))

    def percentile(self, q: float) -> float:
        return percentile(self._samples, q)

    def summary(self) -> Dict[str, float]:
        """count, mean, p50, p95, p99 of the samples."""
        n = self.count
        return {
            "count": n,
            "mean": self.total / n if n else 0.0,
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
            "p99": self.percentile(99.0),
        }


class MetricsRegistry:
    """Name-keyed instruments; same name + kind -> same instrument."""

    def __init__(self) -> None:
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, kind):
        inst = self._instruments.get(name)
        if inst is None:
            inst = kind(name)
            self._instruments[name] = inst
        elif not isinstance(inst, kind):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, not {kind.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def clear(self) -> None:
        self._instruments = {}

    def snapshot(self) -> Dict[str, Any]:
        """Every instrument by sorted name: histograms as summaries."""
        out: Dict[str, Any] = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if isinstance(inst, Histogram):
                out[name] = inst.summary()
            else:
                out[name] = inst.value
        return out


REGISTRY = MetricsRegistry()
