"""What an executor and the continuous-batching scheduler exchange.

Only the two records the LM decode executor needs are ported so far:
``BatchPolicy`` (the size and age triggers) and ``BatchExecution`` (what
one launched batch reports back).  The scheduler itself, its
``ServingLog`` and ``trace_payload`` wait for the serving slice, which
needs ``obs/`` (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses

__all__ = ["BatchExecution", "BatchPolicy"]


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """The two continuous-batching triggers: size and age.

    ``max_batch`` caps how many requests share one launch (the executor
    pads to this capacity so shapes stay stable); a queue whose head is
    older than ``max_wait_s`` launches immediately even if underfull,
    bounding the queueing tail at low offered load.
    """

    max_batch: int = 8
    max_wait_s: float = 0.02

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_s < 0:
            raise ValueError(
                f"max_wait_s must be >= 0, got {self.max_wait_s}")


@dataclasses.dataclass(frozen=True)
class BatchExecution:
    """What an executor reports back for one launched batch.

    ``compute_s`` is what the scheduler folds back into the virtual
    clock.  ``shards`` records how many ways the batch was split
    (1 = unsharded).
    """

    engine: str        # 'vector' | 'matrix' — what actually ran
    compute_s: float   # measured batch compute seconds
    shards: int = 1    # mesh shards the batch was split across
