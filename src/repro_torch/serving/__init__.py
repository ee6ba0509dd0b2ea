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
* :mod:`repro_torch.serving.router` -- the SLO-aware control plane
  (:class:`SLORouter`: shard width + exploration gating from queue depth
  and SLO headroom) and the online-tuning executor
  (:class:`OnlineKernelBatchExecutor`, whose tile bandit is
  :mod:`repro_torch.tuning.online`).
* :mod:`repro_torch.serving.session` -- the one-call session runner.
* :mod:`repro_torch.serving.elastic` -- the elastic, fault-tolerant
  session: mesh resizes under load (``Dispatcher.set_mesh`` +
  ``runtime/elastic.mesh_transition_plan``), bit-exact re-dispatch of a
  failed shard's ShardPlan ranges, checkpoint/restore through
  ``runtime/checkpoint.AsyncCheckpointer``, and the seeded fault/resize
  injector -- evidence for the ``elastic_integrity`` claim.

Entry points: ``python -m repro_torch.bench serve`` (record-producing
sweeps; ``--mesh N`` to shard, ``--chaos`` for fault injection) and
``python -m repro_torch.launch.serve`` (LM serving).
"""
from .batcher import KernelBatchExecutor
from .elastic import (ChaosEvent, ChaosInjector, ElasticKernelExecutor,
                      ElasticSession, checkpoint_session,
                      redispatch_failed_shard)
from .loadgen import (WORKLOADS, BurstyLoadGen, ClosedLoopLoadGen, LoadGen,
                      PoissonLoadGen, TraceLoadGen, load_trace,
                      make_loadgen, save_trace)
from .lm import LMDecodeExecutor, decode_traits
from .metrics import (ServingSummary, format_summary, percentile,
                      serving_record, summarize)
from .requests import LM_DECODE, Request, RequestResult
from .router import OnlineKernelBatchExecutor, RouterDecision, SLORouter
from .scheduler import (BatchExecution, BatchPolicy,
                        ContinuousBatchingScheduler, ServingLog)
from .session import SessionConfig, run_session
from .slo import DEFAULT_SLO, SLO

__all__ = [
    "BatchExecution", "BatchPolicy", "BurstyLoadGen", "ChaosEvent",
    "ChaosInjector", "ClosedLoopLoadGen", "ContinuousBatchingScheduler",
    "DEFAULT_SLO", "ElasticKernelExecutor", "ElasticSession",
    "KernelBatchExecutor", "LMDecodeExecutor", "LM_DECODE", "LoadGen",
    "OnlineKernelBatchExecutor", "PoissonLoadGen", "Request",
    "RequestResult", "RouterDecision", "SLO", "SLORouter", "ServingLog",
    "ServingSummary", "SessionConfig", "TraceLoadGen", "WORKLOADS",
    "checkpoint_session", "decode_traits", "format_summary", "load_trace",
    "make_loadgen", "percentile", "redispatch_failed_shard", "run_session",
    "save_trace", "serving_record", "summarize",
]
