"""Request-level serving over the engine dispatcher, on the card.

The paper's verdict -- matrix engines cannot meaningfully accelerate
memory-bound kernels -- is established per call; this package checks it
**in steady state under load**, where decode/SpMV/stencil-shaped work
arrives as a request stream.  The layers:

* :mod:`repro_torch.serving.requests` -- typed requests/results on a
  virtual serving clock.
* :mod:`repro_torch.serving.loadgen` -- seeded, replayable traffic
  generators (Poisson open-loop, bursty on/off, closed-loop, JSON traces).
* :mod:`repro_torch.serving.scheduler` -- admission queue + continuous
  batching (size/age triggers, oldest-first fairness).
* :mod:`repro_torch.serving.batcher` -- padding-aware packing of
  elementwise families into one launch of the hand-written elementwise
  kernel, engine selection via memoized Advice (§6 routing off the hot
  path), per-request launches for the other families.
* :mod:`repro_torch.serving.lm` -- the LM decode executor (prefill +
  batched greedy decode, every layer's attention through the
  flash-decode kernel).
* :mod:`repro_torch.serving.metrics` / :mod:`repro_torch.serving.slo` --
  latency percentiles with queue/compute split, goodput and SLO
  attainment, emitted as schema-4 records for ``repro_torch.report`` and
  the ``repro_torch.bench.compare`` p99/goodput gate.
* :mod:`repro_torch.serving.session` -- the one-call session runner.

Entry points: ``python -m repro_torch.bench serve`` (record-producing
sweeps) and ``python -m repro_torch.launch.serve`` (LM serving).

Not ported yet: ``router`` (the SLO-aware control plane and the
online-tuning executor; ROADMAP Queue 1 item 12, which brings
``tuning.online``) and ``elastic`` (the fault-tolerant session; items
13-14, which bring ``ShardPlan``, ``runtime/checkpoint`` and
``runtime/elastic``).
"""
from .batcher import KernelBatchExecutor
from .loadgen import (WORKLOADS, BurstyLoadGen, ClosedLoopLoadGen, LoadGen,
                      PoissonLoadGen, TraceLoadGen, load_trace,
                      make_loadgen, save_trace)
from .lm import LMDecodeExecutor, decode_traits
from .metrics import (ServingSummary, format_summary, percentile,
                      serving_record, summarize)
from .requests import LM_DECODE, Request, RequestResult
from .scheduler import (BatchExecution, BatchPolicy,
                        ContinuousBatchingScheduler, ServingLog)
from .session import SessionConfig, run_session
from .slo import DEFAULT_SLO, SLO

__all__ = [
    "BatchExecution", "BatchPolicy", "BurstyLoadGen", "ClosedLoopLoadGen",
    "ContinuousBatchingScheduler", "DEFAULT_SLO", "KernelBatchExecutor",
    "LMDecodeExecutor", "LM_DECODE", "LoadGen", "PoissonLoadGen", "Request",
    "RequestResult", "SLO", "ServingLog", "ServingSummary", "SessionConfig",
    "TraceLoadGen", "WORKLOADS", "decode_traits", "format_summary",
    "load_trace", "make_loadgen", "percentile", "run_session", "save_trace",
    "serving_record", "summarize",
]
