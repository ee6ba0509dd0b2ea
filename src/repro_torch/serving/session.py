"""One-call serving sessions: loadgen -> scheduler -> metrics -> record.

The orchestration layer every serving consumer shares -- the
``python -m repro_torch.bench serve`` sweep, the
``repro_torch.launch.serve`` launcher and ``chip_smoke.py`` all call
:func:`run_session` with a workload name and an executor and get back the
session log, its latency summary, and the schema-4 record dict ready for
``repro_torch.bench.common.write_serving_json``.

Sessions run on the card unless the config asks for the CPU
(``device="cpu"``, ``backend="plain"``).  What waits, and raises
``NotImplementedError`` naming its ROADMAP Queue 1 item: online tile
tuning and SLO routing (``online_tune`` / ``slo_route``, item 12) and the
mesh (``num_shards > 1`` / ``real_mesh``, item 13).  The reference's
``checkpoint_session`` and ``redispatch_failed_shard`` come with the
elastic session (items 13-14).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..core.dispatch import normalize_engine
from ..obs.trace import capture as trace_capture
from .batcher import MESH_WAITS, KernelBatchExecutor
from .loadgen import LoadGen, make_loadgen
from .metrics import ServingSummary, serving_record, summarize
from .scheduler import (BatchPolicy, ContinuousBatchingScheduler,
                        ServingLog, trace_payload)
from .slo import DEFAULT_SLO, SLO

__all__ = ["BACKEND_FOR_DEVICE", "SessionConfig", "run_session"]

#: The backend that runs where the session's tensors live.
BACKEND_FOR_DEVICE = {"cuda": "cuda", "cpu": "plain"}

#: Where online tuning and SLO routing wait.
TUNING_WAITS = ("online tuning and SLO routing wait for ROADMAP Queue 1 "
                "item 12 (tuning)")


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Everything one serving session needs beyond its executor.

    ``device`` / ``backend`` say where the session runs: the card
    (``"cuda"`` / ``"cuda"``, the default) or the CPU with the kernels'
    plain versions (``"cpu"`` / ``"plain"``); any other pair raises.
    """

    kernel: str
    workload: str = "poisson"
    engine: str = "auto"         # session engine flag ('auto'|'vpu'|'mxu')
    rate_rps: float = 64.0
    duration_s: float = 2.0
    size: int = 65536
    dtype: str = "float32"
    seed: int = 0
    policy: BatchPolicy = dataclasses.field(default_factory=BatchPolicy)
    slo: SLO = DEFAULT_SLO
    trace_path: Optional[str] = None
    num_shards: int = 1          # mesh shards per launch (1 = no mesh)
    real_mesh: bool = False
    online_tune: bool = False
    slo_route: bool = False
    device: str = "cuda"
    backend: str = "cuda"

    def __post_init__(self):
        if BACKEND_FOR_DEVICE.get(self.device) != self.backend:
            raise ValueError(
                f"device={self.device!r} with backend={self.backend!r}: "
                f"expected one of {sorted(BACKEND_FOR_DEVICE.items())}")


def run_session(cfg: SessionConfig, executor=None,
                source: Optional[LoadGen] = None,
                ) -> Tuple[ServingLog, ServingSummary, Dict]:
    """Run one serving session and reduce it to a schema-4 record.

    Builds the workload's seeded generator (or uses a caller-supplied
    *source* -- e.g. a trace parsed once for a multi-kernel sweep),
    drives the continuous-batching scheduler against *executor*
    (default: a :class:`~repro_torch.serving.batcher.KernelBatchExecutor`
    honoring the session's engine flag and backend), and joins the
    executor's memoized Advice (Eq. 2 intensity, Eq. 4 boundedness, the
    Eq. 17/23/24 ceiling, §6 auto-routing) onto the summary.
    """
    if cfg.slo_route and not cfg.online_tune:
        raise ValueError("slo_route requires online_tune: the router's "
                         "exploration gate drives the online tuner")
    if cfg.online_tune:
        raise NotImplementedError(TUNING_WAITS)
    if cfg.num_shards > 1 or cfg.real_mesh:
        raise NotImplementedError(
            f"num_shards={cfg.num_shards}, real_mesh={cfg.real_mesh}: "
            f"{MESH_WAITS}")
    if executor is None:
        executor = KernelBatchExecutor(engine=cfg.engine,
                                       max_batch=cfg.policy.max_batch,
                                       seed=cfg.seed, backend=cfg.backend)
    if source is None:
        source = make_loadgen(cfg.workload, cfg.kernel,
                              rate_rps=cfg.rate_rps, size=cfg.size,
                              dtype=cfg.dtype, seed=cfg.seed,
                              trace_path=cfg.trace_path)
    scheduler = ContinuousBatchingScheduler(executor, cfg.policy)
    with trace_capture() as view:
        log = scheduler.run(source, cfg.duration_s)
    trace = trace_payload(view.events, log)
    summary = summarize(log, cfg.slo)
    advice = executor.advice_for(cfg.kernel, cfg.size, cfg.dtype)
    # an idle session still records the engine it *would* have run:
    # the forced one when forced (so vector/matrix records keep
    # distinct join keys), what 'auto' resolves to otherwise
    forced = normalize_engine(cfg.engine)
    engines = {r.engine for r in log.results} or \
        {forced if forced is not None else advice.engine}
    engine = engines.pop() if len(engines) == 1 else "mixed"
    # model-backed executors (LMDecodeExecutor) contribute the model
    # name, the prefill/decode phase split, and the per-op model-scale
    # verdict the model_verdict claim checks; kernel executors don't
    extras = (executor.record_extras()
              if hasattr(executor, "record_extras") else {})
    record = serving_record(
        summary, kernel=cfg.kernel, engine=engine,
        engine_auto=advice.engine, workload=cfg.workload,
        rate_rps=cfg.rate_rps, size=cfg.size, dtype=cfg.dtype,
        seed=cfg.seed, intensity=advice.intensity,
        memory_bound=advice.memory_bound,
        mxu_ceiling=advice.max_speedup_matrix,
        max_batch=cfg.policy.max_batch,
        max_wait_ms=cfg.policy.max_wait_s * 1e3,
        num_shards=cfg.num_shards, mesh_exec_mode=None,
        model=extras.get("model"), phases=extras.get("phases"),
        verdict=extras.get("verdict"), trace=trace)
    return log, summary, record
