"""Roofline terms of a traced step (the dry run's analysis).

The reference's ``core/analysis.py`` derives the three roofline terms of
a (program x mesh) pair from a compiled XLA executable.  Here they come
from the dry run's traces of the step on meta tensors
(``launch/dryrun.py``):

    compute term    = FLOPs            / (chips * dense peak at the dtype)
    memory term     = bytes            / (chips * HBM bandwidth)
    collective term = collective bytes / (chips * link bandwidth)

Collective bytes come from recorded events, not HLO text: each event is
one functional collective that DTensor issued while the sharded step ran,
with its local result bytes:

    all_gather_into_tensor -> all-gather
    all_reduce             -> all-reduce, counted twice (ring =
                              reduce-scatter + all-gather, the n -> inf
                              limit, as the reference counts)
    reduce_scatter_tensor  -> reduce-scatter
    all_to_all_single      -> all-to-all

``wait_tensor``, which completes an issued collective, is the
counterpart of an async pair's ``-done`` and is not counted.  No
functional collective is a permute; the kind stays, at zero, for the
reference's rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

from .hw import H100_SXM, HardwareSpec, dense_peak

__all__ = ["COLLECTIVE_KINDS", "CollectiveStats", "RooflineReport",
           "analyze", "collective_stats"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: Functional collective op -> the reference's kind (None: not counted).
EVENT_KINDS: Dict[str, Optional[str]] = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "wait_tensor": None,
}


@dataclasses.dataclass
class CollectiveStats:
    """Collective bytes (per device) and counts by kind."""

    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


def collective_stats(events: Iterable[Tuple[str, int]]) -> CollectiveStats:
    """Sum the result bytes of recorded collectives, ``(op name, result
    bytes)`` pairs (``all_reduce`` or ``_c10d_functional.all_reduce``)."""
    by_bytes: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
    by_count: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
    for op, nbytes in events:
        name = op.split(".")[-1]
        if name not in EVENT_KINDS:
            raise ValueError(f"not a functional collective: {op!r}")
        kind = EVENT_KINDS[name]
        if kind is None:
            continue
        by_bytes[kind] += int(nbytes) * (2 if kind == "all-reduce" else 1)
        by_count[kind] += 1
    return CollectiveStats(by_bytes, by_count)


@dataclasses.dataclass
class RooflineReport:
    """The three terms of one (program x mesh), as the reference's; the
    peak that ``mfu_bound`` divides by is the spec's (``peak_flops``, the
    dense peak of one chip at the step's dtype)."""

    label: str
    chips: int
    hlo_flops_global: float
    hlo_bytes_global: float
    collective_bytes_global: float
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: Optional[float] = None
    bytes_per_device: Optional[float] = None
    collectives: Optional[CollectiveStats] = None
    peak_flops: float = dense_peak(H100_SXM)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time assuming full overlap of the three streams."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / traced FLOPs: how much of the compute is useful."""
        if self.model_flops is None or self.hlo_flops_global == 0:
            return None
        return self.model_flops / self.hlo_flops_global

    @property
    def mfu_bound(self) -> Optional[float]:
        """Model-flops utilization at the roofline bound time."""
        if self.model_flops is None or self.t_bound == 0:
            return None
        return self.model_flops / (self.t_bound * self.chips
                                   * self.peak_flops)

    def row(self) -> Dict[str, object]:
        return {
            "label": self.label,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops_global,
            "hlo_bytes": self.hlo_bytes_global,
            "coll_bytes": self.collective_bytes_global,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flop_ratio,
            "mfu_bound": self.mfu_bound,
        }


def analyze(label: str, cost: Dict[str, float],
            events: Iterable[Tuple[str, int]], chips: int,
            hw: HardwareSpec = H100_SXM, model_flops: Optional[float] = None,
            bytes_per_device: Optional[float] = None,
            per_device_cost: bool = True,
            dtype: str = "bfloat16") -> RooflineReport:
    """A RooflineReport from a step's cost and its recorded collectives.

    cost: ``flops`` and ``bytes`` (``program_cost``'s keys; the
    reference's ``bytes accessed`` is read too).  per_device_cost: the
    cost is one device's (multiplied by ``chips``), as the reference's
    partitioned module's; ``program_cost`` of the unsharded step is
    global (pass False).  events: per-device collectives.
    """
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes", cost.get("bytes accessed", 0.0)))
    mult = chips if per_device_cost else 1
    stats = collective_stats(events)
    coll_global = stats.total_bytes * chips
    peak = dense_peak(hw, dtype)
    return RooflineReport(
        label=label,
        chips=chips,
        hlo_flops_global=flops * mult,
        hlo_bytes_global=byts * mult,
        collective_bytes_global=float(coll_global),
        t_compute=flops * mult / (chips * peak),
        t_memory=byts * mult / (chips * hw.mem_bw),
        t_collective=coll_global / (chips * (hw.link_bw or 1.0)),
        model_flops=model_flops,
        bytes_per_device=bytes_per_device,
        collectives=stats,
        peak_flops=peak,
    )
