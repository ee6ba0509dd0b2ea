"""SLO semantics for the serving subsystem: targets and attainment.

One service-level objective per session: an end-to-end latency target.
A request *attains* the SLO when its arrival→completion latency is
within ``latency_ms``; **attainment** is the attained fraction of
completed requests and **goodput** is attained requests per second —
the rate the service delivers *usefully*, which is the number the
paper's engine question has to be judged on under load (a matrix-engine
variant that inflates p99 past the SLO loses goodput even at equal
mean throughput).  Pure Python, copied from the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from .requests import RequestResult

__all__ = ["DEFAULT_SLO", "SLO", "availability"]


def availability(completed: int, offered: int) -> float:
    """Served fraction of the offered load (1.0 for an idle session).

    The elastic-serving availability metric: injected failures
    re-dispatch instead of dropping, so a healthy elastic session
    completes every admitted arrival and reports 1.0; anything below the
    ``availability_target`` fails the ``elastic_integrity`` claim.
    """
    if offered <= 0:
        return 1.0
    return completed / offered


@dataclasses.dataclass(frozen=True)
class SLO:
    """An end-to-end latency objective, in milliseconds."""

    latency_ms: float = 50.0

    def __post_init__(self):
        if self.latency_ms <= 0:
            raise ValueError(
                f"latency_ms must be > 0, got {self.latency_ms}")

    def attained(self, result: RequestResult) -> bool:
        """True iff this completed request met the latency target."""
        return result.ok and result.latency_s * 1e3 <= self.latency_ms

    def attainment(self, results: Iterable[RequestResult]) -> float:
        """Attained fraction of completed requests (1.0 when idle)."""
        done = [r for r in results if r.ok]
        if not done:
            return 1.0
        return sum(1 for r in done if self.attained(r)) / len(done)

    def goodput_rps(self, results: Iterable[RequestResult],
                    duration_s: float) -> float:
        """SLO-attaining completions per second of session horizon."""
        if duration_s <= 0:
            return 0.0
        return sum(1 for r in results if self.attained(r)) / duration_s


#: The session default: 50 ms end-to-end, a latency-sensitive inference
#: tier's typical per-call budget.
DEFAULT_SLO = SLO()
