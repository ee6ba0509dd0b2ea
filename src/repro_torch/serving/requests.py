"""Typed serving requests and their per-request latency results.

The unit of the serving subsystem (paper §6 under load): a
:class:`Request` names *what* arrives (a registered kernel family or
the LM decode path), *when* it arrives on the virtual serving clock,
and *how big* it is; a :class:`RequestResult` records what the
scheduler did with it — when its batch launched, when it finished, and
through which engine — so the metrics layer can split queueing from
compute and the claims report can check §6 routing in steady state.

Arrival and completion times live on a **virtual clock** (seconds,
starting at 0 when a serving session starts): traffic generators emit
arrivals deterministically from a seed, while batch compute times are
measured wall time folded back into the same clock.  That hybrid is
what makes sessions replayable off-hardware without pretending the
kernel launches are free.  Pure Python, copied from the reference
package.
"""
from __future__ import annotations

import dataclasses

__all__ = ["LM_DECODE", "Request", "RequestResult"]

#: Pseudo-kernel name for the LM decode path (``serving.lm``); every
#: other kernel name must resolve in ``kernels.registry``.
LM_DECODE = "lm-decode"


@dataclasses.dataclass(frozen=True)
class Request:
    """One unit of offered load against the engine dispatcher.

    ``size`` is the request's work descriptor: elements for a kernel
    family, tokens to generate for :data:`LM_DECODE`.  ``client``
    identifies the closed-loop client (or trace stream) that issued it;
    open-loop generators leave it 0.
    """

    rid: int            # unique within one serving session
    kernel: str         # registry family name, or LM_DECODE
    arrival_s: float    # virtual-clock arrival time (seconds)
    size: int           # elements (kernel) / tokens to decode (LM)
    dtype: str = "float32"
    client: int = 0     # closed-loop client / trace stream id

    @property
    def batch_key(self):
        """Requests sharing this key may be packed into one launch."""
        return (self.kernel, self.dtype)


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """One served request: its batch placement and latency split.

    ``start_s`` is when the batch containing this request launched;
    everything between arrival and start is queueing, everything
    between start and finish is (shared) batch compute — the split the
    metrics layer reports as queue/compute percentiles.
    """

    request: Request
    start_s: float      # batch launch time on the virtual clock
    finish_s: float     # batch completion time on the virtual clock
    batch_id: int       # which formed batch served this request
    batch_size: int     # how many requests shared the launch
    engine: str         # 'vector' | 'matrix' — what actually ran
    ok: bool = True     # False = admission rejected / failed

    @property
    def queue_s(self) -> float:
        """Seconds spent waiting for batch formation."""
        return self.start_s - self.request.arrival_s

    @property
    def compute_s(self) -> float:
        """Seconds of (shared) batch compute this request rode."""
        return self.finish_s - self.start_s

    @property
    def latency_s(self) -> float:
        """End-to-end seconds from arrival to completion."""
        return self.finish_s - self.request.arrival_s
