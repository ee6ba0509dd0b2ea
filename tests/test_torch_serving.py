"""The serving slice: loadgen, scheduler, metrics, batcher and sessions.

The reference runs as its own tests run it (``tests/test_serving.py``:
JAX on the CPU, the Pallas kernels in interpret mode); the port runs on
the CPU with the kernels' plain versions (``device="cpu"``,
``backend="plain"``).  Inputs and traffic come from numpy seeds.

What must agree, and how closely:

* load generators: the arrival streams exactly, at three seeds;
* the scheduler driven by the same fixed-compute executor: the
  ``ServingLog`` and the ``trace_payload`` exactly, and ``summarize`` /
  ``serving_record`` field for field;
* the batcher's packed SCALE / Triad / AXPY output against the
  reference's packed launch: float32 max-abs <= 1e-4 (the report's
  accuracy claim), and bit for bit on the vector engine, whose fused
  multiply-add both packages round once;
* a session's non-timing record fields (engine, ``engine_auto``,
  intensity, ``memory_bound``, ``mxu_ceiling``, offered, completed).

The reference's policy, starvation, fairness, tie-break and
oversized-batch tests run here as cases over seeds against the port.
The SLO router decides as the reference's on the same signals, and an
online-tuned session's record replays through ``online_ceiling``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro.kernels import registry as j_registry  # noqa: E402
from repro.obs.trace import capture as j_capture  # noqa: E402
from repro import serving as J  # noqa: E402
from repro.serving.scheduler import trace_payload as j_trace_payload  # noqa: E402

from repro_torch import serving as P  # noqa: E402
from repro_torch.kernels import registry as p_registry  # noqa: E402
from repro_torch.obs.trace import capture as p_capture  # noqa: E402
from repro_torch.serving.scheduler import trace_payload as p_trace_payload  # noqa: E402

SEEDS = (0, 1, 7)
ELEMENTWISE = ("scale", "triad", "axpy")
ENGINES = ("vector", "matrix")
F32_TOL = 1e-4   # src/repro/report/claims.py's float32 accuracy claim


def _gens(pkg, seed, kernel="scale"):
    """The four workload models with the same knobs, from one package."""
    return {
        "poisson": pkg.PoissonLoadGen(kernel=kernel, rate_rps=300, size=64,
                                      seed=seed),
        "bursty": pkg.BurstyLoadGen(kernel=kernel, rate_hi=400, rate_lo=20,
                                    period_s=0.25, duty=0.5, size=64,
                                    seed=seed),
        "closed": pkg.ClosedLoopLoadGen(kernel=kernel, clients=3,
                                        think_s=0.004, size=64, seed=seed),
    }


def _fields(req):
    return dataclasses.astuple(req)


def _result_fields(res):
    return (_fields(res.request),) + tuple(
        getattr(res, f.name) for f in dataclasses.fields(res)
        if f.name != "request")


class FakeExecutor:
    """Deterministic executor: fixed per-batch compute, no kernels."""

    def __init__(self, pkg, compute_s=0.003, engine="vector"):
        self.pkg = pkg
        self.compute_s = compute_s
        self.engine = engine
        self.batches = []

    def execute(self, batch):
        self.batches.append(list(batch))
        return self.pkg.BatchExecution(engine=self.engine,
                                       compute_s=self.compute_s)


def _serve(pkg, gen, *, max_batch=4, max_wait_s=0.01, duration=0.5,
           compute_s=0.003):
    ex = FakeExecutor(pkg, compute_s=compute_s)
    sched = pkg.ContinuousBatchingScheduler(
        ex, pkg.BatchPolicy(max_batch=max_batch, max_wait_s=max_wait_s))
    return sched.run(gen, duration), ex


# -- load generators ----------------------------------------------------------

@pytest.mark.parametrize("workload", ["poisson", "bursty", "closed"])
@pytest.mark.parametrize("seed", SEEDS)
def test_loadgen_arrivals_equal_reference(workload, seed):
    j, p = _gens(J, seed)[workload], _gens(P, seed)[workload]
    for horizon in (0.05, 0.5):
        want = [_fields(r) for r in j.initial(horizon)]
        assert [_fields(r) for r in p.initial(horizon)] == want
        assert want


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_round_trips_between_packages(tmp_path, seed):
    mixed = (J.PoissonLoadGen(kernel="scale", rate_rps=60, seed=seed)
             .initial(1.0)
             + J.PoissonLoadGen(kernel="triad", rate_rps=60, seed=seed + 1)
             .initial(1.0))
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    J.save_trace(str(ref_path), mixed)
    P.save_trace(str(port_path), [P.Request(*_fields(r)) for r in mixed])
    assert port_path.read_bytes() == ref_path.read_bytes()
    for kernel in ("scale", "triad"):
        want = J.make_loadgen("trace", kernel,
                              trace_path=str(ref_path)).initial(1.0)
        got = P.make_loadgen("trace", kernel,
                             trace_path=str(ref_path)).initial(1.0)
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
        assert all(r.kernel == kernel for r in got)
    with pytest.raises(ValueError, match="no requests for kernel"):
        P.make_loadgen("trace", "axpy", trace_path=str(port_path))
    port_path.write_text(json.dumps({"schema": 99}))
    with pytest.raises(ValueError, match="schema"):
        P.load_trace(str(port_path))


def test_make_loadgen_dispatches_and_validates():
    for name in ("poisson", "bursty", "closed"):
        assert P.make_loadgen(name, "scale").name == name
    assert P.WORKLOADS == J.WORKLOADS
    with pytest.raises(ValueError, match="trace"):
        P.make_loadgen("trace", "scale")
    with pytest.raises(ValueError, match="unknown workload"):
        P.make_loadgen("nope", "scale")


# -- scheduler ----------------------------------------------------------------

def _log_fields(log):
    return ([_result_fields(r) for r in log.results], list(log.batches),
            log.offered, log.duration_s, log.completed, log.mean_batch)


@pytest.mark.parametrize("workload", ["poisson", "bursty", "closed"])
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_log_and_trace_payload_equal_reference(workload, seed):
    with j_capture() as jv:
        jlog, _ = _serve(J, _gens(J, seed)[workload])
    with p_capture() as pv:
        plog, _ = _serve(P, _gens(P, seed)[workload])
    assert _log_fields(plog) == _log_fields(jlog)
    assert p_trace_payload(pv.events, plog) == \
        j_trace_payload(jv.events, jlog)
    # the same virtual timeline, span for span
    strip = [(e.name, e.clock, e.start_us, e.dur_us, e.kind, e.attrs)
             for e in pv.events]
    assert strip == [(e.name, e.clock, e.start_us, e.dur_us, e.kind,
                      e.attrs) for e in jv.events]


@pytest.mark.parametrize("seed", SEEDS)
def test_summarize_and_record_equal_reference(seed):
    jlog, _ = _serve(J, _gens(J, seed)["poisson"], compute_s=0.004)
    plog, _ = _serve(P, _gens(P, seed)["poisson"], compute_s=0.004)
    js = J.summarize(jlog, J.SLO(latency_ms=12.0))
    ps = P.summarize(plog, P.SLO(latency_ms=12.0))
    assert dataclasses.asdict(ps) == dataclasses.asdict(js)
    assert ps.compute_p50_ms == pytest.approx(4.0, abs=1e-6)
    assert P.format_summary(ps) == J.format_summary(js)
    kw = dict(kernel="scale", engine="vector", engine_auto="vector",
              workload="poisson", rate_rps=300.0, size=64, dtype="float32",
              seed=seed, intensity=0.125, memory_bound=True,
              mxu_ceiling=1.0, max_batch=4, max_wait_ms=10.0,
              model="m", phases={"decode_ms": 1.0}, verdict={"ops": []},
              trace={"clock": "virtual"})
    assert P.serving_record(ps, **kw) == J.serving_record(js, **kw)


def test_percentiles_match_reference():
    xs = np.random.default_rng(0).exponential(10.0, size=257).tolist()
    for q in (0.0, 25.0, 50.0, 95.0, 99.0, 100.0):
        assert P.percentile(xs, q) == J.percentile(xs, q)
    assert P.percentile([], 99.0) == 0.0
    with pytest.raises(ValueError):
        P.percentile(xs, 101.0)


@pytest.mark.parametrize("kwargs,match", [
    ({"max_batch": 0}, "max_batch"), ({"max_wait_s": -1.0}, "max_wait_s"),
])
def test_policy_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        P.BatchPolicy(**kwargs)
    with pytest.raises(ValueError, match=match):
        J.BatchPolicy(**kwargs)


def test_slo_validation_and_availability():
    with pytest.raises(ValueError, match="latency_ms"):
        P.SLO(latency_ms=0.0)
    from repro.serving.slo import availability as j_avail
    from repro_torch.serving.slo import availability as p_avail
    for done, offered in ((3, 4), (0, 0), (5, 5)):
        assert p_avail(done, offered) == j_avail(done, offered)


@pytest.mark.parametrize("seed", SEEDS)
def test_no_starvation_every_arrival_is_served(seed):
    gen = P.PoissonLoadGen(kernel="scale", rate_rps=300, size=64, seed=seed)
    log, _ = _serve(P, gen, duration=1.0)
    assert log.offered == len(gen.initial(1.0))
    assert log.completed == log.offered
    assert {r.request.rid for r in log.results} == \
        {r.rid for r in gen.initial(1.0)}


@pytest.mark.parametrize("seed", SEEDS)
def test_batch_size_and_age_bounds(seed):
    gen = P.PoissonLoadGen(kernel="scale", rate_rps=500, size=64, seed=seed)
    log, ex = _serve(P, gen, max_batch=3, duration=1.0)
    assert ex.batches and all(len(b) <= 3 for b in ex.batches)
    # a lone request never waits past max_wait_s for companions
    gen = P.PoissonLoadGen(kernel="scale", rate_rps=5, size=64, seed=seed)
    log, _ = _serve(P, gen, max_batch=64, max_wait_s=0.02, duration=2.0,
                    compute_s=0.0001)
    assert log.completed > 0
    assert all(r.queue_s <= 0.02 + 0.0001 + 1e-9 for r in log.results)


@pytest.mark.parametrize("seed", SEEDS)
def test_fifo_within_batch_key(seed):
    gen = P.PoissonLoadGen(kernel="scale", rate_rps=400, size=64, seed=seed)
    log, _ = _serve(P, gen, duration=1.0)
    by_arrival = sorted(log.results, key=lambda r: r.request.arrival_s)
    starts = [r.start_s for r in by_arrival]
    assert starts == sorted(starts)  # earlier arrival never starts later


class _ListGen:
    name = "list"

    def __init__(self, reqs):
        self._reqs = reqs

    def initial(self, duration_s):
        return [r for r in self._reqs if r.arrival_s < duration_s]

    def on_complete(self, result, duration_s):
        return None


@pytest.mark.parametrize("first", ["triad", "scale"])
def test_same_timestamp_ties_dequeue_in_arrival_order(first):
    """Two queue heads admitted at one virtual timestamp dequeue in
    arrival (rid) order, not in the order their queues were created."""
    other = "scale" if first == "triad" else "triad"
    reqs = [P.Request(rid=0, kernel=first, arrival_s=0.0, size=64),
            P.Request(rid=1, kernel=other, arrival_s=0.01, size=64),
            P.Request(rid=2, kernel=first, arrival_s=0.01, size=64)]
    ex = FakeExecutor(P)
    log = P.ContinuousBatchingScheduler(
        ex, P.BatchPolicy(max_batch=1, max_wait_s=0.05)).run(
            _ListGen(reqs), 1.0)
    assert log.completed == 3
    starts = {r.request.rid: r.start_s for r in log.results}
    assert starts[0] < starts[1] < starts[2]


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_loop_concurrency_bounded_by_clients(seed):
    gen = P.ClosedLoopLoadGen(kernel="scale", clients=3, think_s=0.001,
                              seed=seed)
    log, _ = _serve(P, gen, max_batch=8, duration=1.0)
    assert log.completed == log.offered
    assert all(r.batch_size <= 3 for r in log.results)
    per_client = {}
    for r in log.results:
        per_client.setdefault(r.request.client, []).append(r)
    for results in per_client.values():
        ordered = sorted(results, key=lambda r: r.request.arrival_s)
        for prev, nxt in zip(ordered, ordered[1:]):
            assert nxt.request.arrival_s >= prev.finish_s


def test_on_dequeue_hook_sees_each_batch_before_launch():
    seen = []

    class Hooked(FakeExecutor):
        def on_dequeue(self, batch, *, clock_s, queue_depth):
            seen.append((len(batch), clock_s, queue_depth,
                         len(self.batches)))

    ex = Hooked(P)
    gen = P.PoissonLoadGen(kernel="scale", rate_rps=300, size=64, seed=0)
    log = P.ContinuousBatchingScheduler(ex, P.BatchPolicy(4, 0.01)).run(
        gen, 0.5)
    assert [s[0] for s in seen] == [b[2] for b in log.batches]
    assert [s[1] for s in seen] == [b[3] for b in log.batches]
    assert [s[3] for s in seen] == list(range(len(log.batches)))
    assert all(d >= n for n, _, d, _ in seen)


# -- the batcher --------------------------------------------------------------

def _requests(pkg, kernel, sizes):
    return [pkg.Request(rid=i, kernel=kernel, arrival_s=0.0, size=n)
            for i, n in enumerate(sizes)]


def _reference_packed(jex, kernel, batch, engine):
    """The reference's packed launch (``KernelBatchExecutor._run_packed``
    without the timing) on its own executor's canonical inputs."""
    import jax.numpy as jnp
    op = j_registry.get(kernel)
    dtype = batch[0].dtype
    per_req = [jex._canonical(kernel, r.size, dtype) for r in batch]
    total = sum(r.size for r in batch)
    cap = jex._capacity(kernel, engine,
                        max(jex.max_batch * max(r.size for r in batch),
                            total), dtype)
    packed = []
    for i, a in enumerate(per_req[0][0]):
        if hasattr(a, "shape"):
            cat = jnp.concatenate([args[i] for args, _ in per_req])
            packed.append(jnp.pad(cat, (0, cap - cat.shape[0])))
        else:
            packed.append(a)
    return np.asarray(op(*packed, engine=engine, interpret=True))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kernel", ELEMENTWISE)
def test_packed_output_matches_reference(kernel, engine):
    sizes = (4096, 4093, 1000)
    jex = J.KernelBatchExecutor(engine=engine, max_batch=4, seed=3)
    pex = P.KernelBatchExecutor(engine=engine, max_batch=4, seed=3,
                                backend="plain")
    want = _reference_packed(jex, kernel, _requests(J, kernel, sizes),
                             engine)
    out, got_sizes = pex.packed_call(_requests(P, kernel, sizes))
    assert got_sizes == list(sizes)
    assert tuple(out.shape) == want.shape == (256 * 1024,)
    got = out.numpy()
    assert float(np.max(np.abs(got - want))) <= F32_TOL
    if engine == "vector":
        assert np.array_equal(got, want)
    # sliced per request: the kernel on each request's own input; the
    # padding is zero
    off = 0
    op = p_registry.get(kernel)
    for n in sizes:
        args, kw = pex._canonical(kernel, n, "float32")
        assert torch.equal(out[off:off + n],
                           op(*args, engine=engine, backend="plain", **kw))
        off += n
    assert not bool(out[off:].any())


@pytest.mark.parametrize("kernel", ELEMENTWISE)
def test_batcher_survives_oversized_policy_batches(kernel):
    """A scheduler policy with a larger max_batch than the executor's
    costs another launch shape, never a negative-pad crash."""
    ex = P.KernelBatchExecutor(engine="vpu", max_batch=2, backend="plain")
    batch = _requests(P, kernel, [4096] * 5)  # 5 > the capacity of 2
    result = ex.execute(batch)
    assert result.engine == "vector" and result.compute_s > 0
    out, _ = ex.packed_call(batch)
    assert out.shape[0] == 5 * 4096 + (256 * 1024 - 5 * 4096)


@pytest.mark.parametrize("kernel", ["spmv", "stencil", "attention"])
def test_unpackable_families_run_per_request(kernel):
    ex = P.KernelBatchExecutor(engine="mxu", backend="plain")
    size = p_registry.get(kernel).test_size
    args, kw = ex._canonical(kernel, size, "float32")
    assert not ex._packable(args, kw, size)
    result = ex.execute(_requests(P, kernel, [size] * 3))
    assert result.engine == "matrix" and result.compute_s > 0
    with pytest.raises(ValueError, match="does not pack"):
        ex.packed_call(_requests(P, kernel, [size]))


@pytest.mark.parametrize("args,packable", [
    ((torch.zeros(8), 1.5), True),
    ((torch.zeros(8), torch.tensor(1.5)), True),   # a 0-d tensor: a scalar
    ((torch.zeros(8), torch.zeros(8), 2), True),
    ((torch.zeros(7), 1.5), False),
    ((torch.zeros(2, 4), 1.5), False),
    ((1.5, 2.0), False),                            # nothing to pack
    ((torch.zeros(8), "x"), False),
])
def test_packable_takes_tensors_and_python_scalars(args, packable):
    assert P.KernelBatchExecutor._packable(args, {}, 8) is packable


def test_packed_zero_d_scalar_rides_along():
    ex = P.KernelBatchExecutor(engine="vector", max_batch=2, backend="plain")
    b = torch.arange(6, dtype=torch.float32)
    ex.use_inputs("scale", 6, "float32", (b, torch.tensor(2.0)), {})
    out, _ = ex.packed_call(_requests(P, "scale", [6, 6]))
    assert torch.equal(out[:12], torch.cat([2 * b, 2 * b]))


@pytest.mark.parametrize("kwargs,match", [
    ({"num_shards": 2}, "item 13"), ({"real_mesh": True}, "item 13"),
])
def test_batcher_mesh_waits(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        P.KernelBatchExecutor(backend="plain", **kwargs)


def test_card_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        P.KernelBatchExecutor()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        P.run_session(P.SessionConfig(kernel="scale"))


# -- sessions -----------------------------------------------------------------

RECORD_FIELDS = ("kernel", "engine", "engine_auto", "intensity",
                 "memory_bound", "mxu_ceiling", "offered", "completed",
                 "workload", "rate_rps", "duration_s", "size", "dtype",
                 "seed", "max_batch", "max_wait_ms", "num_shards",
                 "mesh_exec_mode", "slo_ms")

SESSION_SIZES = {"scale": 4096, "triad": 4096, "axpy": 4096, "spmv": 128,
                 "stencil": 48, "attention": 256}


@pytest.mark.parametrize("engine", ["auto", "vpu", "mxu"])
@pytest.mark.parametrize("kernel", sorted(SESSION_SIZES))
def test_session_record_fields_equal_reference(kernel, engine):
    common = dict(kernel=kernel, workload="poisson", engine=engine,
                  rate_rps=40, duration_s=0.2, size=SESSION_SIZES[kernel],
                  seed=0)
    _, _, want = J.run_session(J.SessionConfig(
        policy=J.BatchPolicy(max_batch=4, max_wait_s=0.01), **common))
    log, _, got = P.run_session(P.SessionConfig(
        policy=P.BatchPolicy(max_batch=4, max_wait_s=0.01), device="cpu",
        backend="plain", **common))
    assert {f: got[f] for f in RECORD_FIELDS} == \
        {f: want[f] for f in RECORD_FIELDS}
    assert set(got) == set(want)
    assert got["batches"] == want["batches"] == len(log.batches)
    assert got["trace"]["batch_spans"] == want["trace"]["batch_spans"]
    assert got["memory_bound"] is True and got["engine_auto"] == "vector"


def test_session_end_to_end_verifies(tmp_path):
    from repro_torch.bench.common import write_serving_json
    from repro_torch.report import check_records, load_file, violations
    cfg = P.SessionConfig(kernel="scale", rate_rps=40, duration_s=0.3,
                          size=4096, seed=0, device="cpu", backend="plain",
                          policy=P.BatchPolicy(max_batch=4, max_wait_s=0.01))
    log, summary, record = P.run_session(cfg)
    assert log.completed == log.offered > 0
    assert record["engine"] == record["engine_auto"] == "vector"
    assert record["p50_ms"] <= record["p99_ms"]
    path = write_serving_json("scale", [record], str(tmp_path),
                              env={"hw_model": "H100-SXM5"})
    rs = load_file(path)
    assert rs.kind == "serving" and rs.schema == 5
    results = check_records([rs])
    assert violations(results) == []
    assert [r.claim for r in results][-1] == "trace_reconciliation"


@pytest.mark.parametrize("kwargs,exc,match", [
    ({"online_tune": True, "num_shards": 2}, NotImplementedError,
     "item 13"),
    ({"online_tune": True, "slo_route": True}, NotImplementedError,
     "item 13"),
    ({"slo_route": True}, ValueError, "requires online_tune"),
    ({"num_shards": 2}, NotImplementedError, "item 13"),
    ({"real_mesh": True}, NotImplementedError, "item 13"),
])
def test_session_waiting_options_raise(kwargs, exc, match):
    cfg = P.SessionConfig(kernel="scale", device="cpu", backend="plain",
                          **kwargs)
    with pytest.raises(exc, match=match):
        P.run_session(cfg)


@pytest.mark.parametrize("device,backend", [("cpu", "cuda"),
                                            ("cuda", "plain"),
                                            ("tpu", "plain")])
def test_session_config_device_backend_must_agree(device, backend):
    with pytest.raises(ValueError, match="device="):
        P.SessionConfig(kernel="scale", device=device, backend=backend)


def test_lm_session_record_matches_reference():
    """One LM decode session on carried weights: the reference's
    non-timing record fields, its model and its verdict's ops."""
    from repro.configs import get_arch as j_arch, reduced as j_reduced
    from repro_torch.configs import get_arch as p_arch, reduced as p_reduced
    kw = dict(max_batch=2, prompt_len=6, max_gen=3, seed=0)
    jex = J.LMDecodeExecutor(j_reduced(j_arch("deepseek-7b")),
                             verdict_cfg=j_arch("deepseek-7b"), **kw)
    pex = P.LMDecodeExecutor(p_reduced(p_arch("deepseek-7b")),
                             verdict_cfg=p_arch("deepseek-7b"),
                             device="cpu", **kw)
    common = dict(kernel="lm-deepseek-7b", workload="lm", engine="vector",
                  rate_rps=8.0, duration_s=0.5, size=3, seed=0)
    _, _, want = J.run_session(
        J.SessionConfig(policy=J.BatchPolicy(2, 0.02), **common), jex,
        J.PoissonLoadGen(kernel="lm-deepseek-7b", rate_rps=8.0, size=3))
    log, _, got = P.run_session(
        P.SessionConfig(policy=P.BatchPolicy(2, 0.02), device="cpu",
                        backend="plain", **common), pex,
        P.PoissonLoadGen(kernel="lm-deepseek-7b", rate_rps=8.0, size=3))
    assert {f: got[f] for f in RECORD_FIELDS} == \
        {f: want[f] for f in RECORD_FIELDS}
    assert got["model"] == want["model"] == "deepseek-7b"
    assert [o["name"] for o in got["verdict"]["ops"]] == \
        [o["name"] for o in want["verdict"]["ops"]]
    assert got["phases"]["launches"] == len(log.batches) == \
        want["phases"]["launches"]


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kernel", ELEMENTWISE)
def test_card_packed_batch_bit_equal_per_request_kernel(card, kernel,
                                                        engine):
    ex = P.KernelBatchExecutor(engine=engine, max_batch=4, seed=0)
    sizes = (1 << 20, (1 << 20) - 3, 1000, 8)
    op = p_registry.get(kernel)
    out, got = ex.packed_call(_requests(P, kernel, sizes))
    assert got == list(sizes) and out.is_cuda
    off = 0
    for n in sizes:
        args, kw = ex._canonical(kernel, n, "float32")
        assert torch.equal(out[off:off + n], op(*args, engine=engine, **kw))
        off += n
    assert not bool(out[off:].any())


# -- online tuning and the SLO router ------------------------------------------

_SIGNALS = [(0.001 * i, depth, wait) for i, (depth, wait) in enumerate(
    [(1, 0.0), (20, 30.0), (20, 45.0), (17, 10.0), (3, 5.0), (2, 1.0),
     (0, 0.0), (16, 26.0), (40, 49.0), (15, 24.9), (1, 60.0)])]


@pytest.mark.parametrize("max_width,grow,shrink", [(1, 16, 2), (4, 16, 2),
                                                   (8, 4, 0)])
def test_slo_router_decides_as_the_reference(max_width, grow, shrink):
    from repro.serving.router import SLORouter as JRouter
    kw = dict(slo_ms=50.0, max_width=max_width, grow_depth=grow,
              shrink_depth=shrink)
    router, jrouter = P.SLORouter(**kw), JRouter(**kw)
    for clock, depth, wait in _SIGNALS:
        got = router.decide(clock_s=clock, engine="vector",
                            queue_depth=depth, oldest_wait_ms=wait)
        want = jrouter.decide(clock_s=clock, engine="vector",
                              queue_depth=depth, oldest_wait_ms=wait)
        assert got.to_json() == want.to_json()
    assert router.payload() == jrouter.payload()


def test_online_executor_refuses_widths_above_one():
    with pytest.raises(NotImplementedError, match="item 13"):
        P.OnlineKernelBatchExecutor(backend="plain",
                                    router=P.SLORouter(max_width=2))


@pytest.mark.parametrize("kernel", ["scale", "triad", "axpy"])
def test_online_session_records_replay(kernel):
    """An online session on the plain backend: one bandit decision per
    packed batch, the arms the reference's candidates, explored in
    order."""
    from repro.tuning.tuner import candidates as j_candidates
    cfg = P.SessionConfig(kernel=kernel, rate_rps=64.0, duration_s=0.3,
                          size=4096, device="cpu", backend="plain",
                          online_tune=True, tune_budget=4)
    log, summary, record = P.run_session(cfg)
    t = record["tuning"]
    key = f"{kernel}|vector|float32|full"
    assert list(t["keys"]) == [key] and t["budget"] == 4
    assert t["decisions"] == len(log.batches) == summary.batches
    arms = t["keys"][key]["arms"]
    assert arms == [dict(sorted(a.items())) for a in
                    j_candidates(j_registry.get(kernel), 4)]
    assert [e["arm"] for e in t["keys"][key]["events"]][:4] == [0, 1, 2, 3]
    assert record["engine"] == record["engine_auto"] == "vector"


def test_online_session_with_a_width_one_router(tmp_path):
    from repro_torch.bench.common import bench_env, write_serving_json
    from repro_torch.report import check_records, load_file, violations
    from repro_torch.tuning import OnlineTuner
    router = P.SLORouter(slo_ms=50.0, max_width=1)
    ex = P.OnlineKernelBatchExecutor(backend="plain", tuner=OnlineTuner(3),
                                     router=router)
    cfg = P.SessionConfig(kernel="axpy", rate_rps=64.0, duration_s=0.3,
                          size=4096, device="cpu", backend="plain",
                          online_tune=True, tune_budget=3)
    log, _, record = P.run_session(cfg, executor=ex)
    decisions = record["tuning"]["router"]["decisions"]
    assert len(decisions) == len(log.batches)
    assert {d["width"] for d in decisions} == {1}
    path = write_serving_json("axpy", [record], str(tmp_path),
                              env=bench_env("cpu", "H100-SXM5"),
                              suffix="_online")
    assert path.endswith("BENCH_serve_axpy_online.json")
    results = check_records([load_file(path)])
    assert not violations(results)
    assert "online_ceiling" in {r.claim for r in results}
