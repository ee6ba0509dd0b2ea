"""The port's ``obs`` package against the reference's ``repro.obs``.

* The same span events export to the same Chrome-trace bytes, and the
  committed chaos trace round-trips byte for byte through the port.
* The validator reports the same problems on the same broken payloads.
* Histogram percentiles, registry snapshots and log lines are identical.
* ``time_fn``'s spans are its samples; ``Dispatcher.run``'s launch spans
  carry the reference's attribute keys and the same traffic and work.
* With the tracer off, neither emits anything.
"""
import io
import pathlib
import statistics

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro.kernels import registry as j_registry  # noqa: E402
from repro.obs import log as j_log  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402

from repro_torch.core.timing import time_fn  # noqa: E402
from repro_torch.kernels import registry as p_registry  # noqa: E402
from repro_torch.obs import log as p_log  # noqa: E402
from repro_torch.obs import metrics as p_metrics  # noqa: E402
from repro_torch.obs import trace as p_trace  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
CHAOS_TRACE = REPO / "runs" / "TRACE_chaos_scale_mesh2.json"
NAMES = ("attention", "axpy", "scale", "spmv", "stencil", "triad")


def _events(mod):
    """A timeline with both clocks, nesting, instants, float residue from
    an s -> us conversion and assorted attribute types."""
    E = mod.SpanEvent
    return [
        E("dispatch", "dispatch", "wall", 0.1 + 0.2, 1e6 / 3, 0, -1,
          attrs={"kernel": "scale", "engine": "vector"}),
        E("launch", "dispatch", "wall", 1.000000000001, 333.3333333333333,
          1, 0, attrs={"traffic_bytes": 8e6, "pct_of_bound": 12.3456}),
        E("iteration", "timing", "wall", 2.5e-7 * 1e6, 0.1 * 3, 0, -1,
          attrs={"iter": 0, "size": 300000, "dtype": "float32"}),
        E("batch", "serving", "virtual", 1.5e6, 2.0e3, attrs={"n": 4}),
        E("fail", "chaos", "virtual", 1.75e6, 0.0, kind="instant",
          attrs={"shard": 1, "skipped": False}),
        E("mark", "chaos", "wall", 7.0, 0.0, 0, -1, kind="instant"),
    ]


@pytest.mark.parametrize("meta", [None, {"source": "test", "mesh": 2}],
                         ids=["no-meta", "meta"])
@pytest.mark.parametrize("cut", [None, "wall", "virtual"],
                         ids=["both-clocks", "wall-only", "virtual-only"])
def test_export_bytes_match_reference(meta, cut):
    def pick(events):
        return [e for e in events if cut is None or e.clock == cut]
    got = p_trace.dump_chrome_trace(
        p_trace.chrome_trace(pick(_events(p_trace)), meta))
    want = j_trace.dump_chrome_trace(
        j_trace.chrome_trace(pick(_events(j_trace)), meta))
    assert got == want


def test_committed_chaos_trace_round_trips_byte_for_byte(tmp_path):
    raw = CHAOS_TRACE.read_text()
    payload = p_trace.read_chrome_trace(str(CHAOS_TRACE))
    assert p_trace.dump_chrome_trace(payload) == raw
    out = tmp_path / "again.json"
    out.write_text(p_trace.dump_chrome_trace(payload))
    assert p_trace._main([str(out)]) == 0


BROKEN = [
    [],
    {"traceEvents": "nope"},
    {"traceEvents": []},
    {"traceEvents": [3, {"ph": "Q"}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 0,
                      "ts": "0", "dur": -1}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 0,
                      "ts": 0.0}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 0, "ts": 1,
                      "dur": -2.5}, {"ph": "i", "pid": 2}]},
    {"traceEvents": [{"ph": "M", "name": "process_name", "pid": 1,
                      "tid": 0}]},
]


@pytest.mark.parametrize("payload", BROKEN, ids=range(len(BROKEN)))
def test_validator_matches_reference(payload):
    assert p_trace.validate_chrome_trace(payload) == \
        j_trace.validate_chrome_trace(payload)


def test_validator_cli_fails_on_a_broken_file(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"traceEvents": []}')
    assert p_trace._main([str(bad)]) == 1


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100, 1001])
def test_histogram_matches_reference(n):
    values = np.random.default_rng(n).lognormal(3.0, 1.0, n)
    hp, hj = p_metrics.Histogram("h"), j_metrics.Histogram("h")
    for v in values:
        hp.observe(v)
        hj.observe(v)
    for q in (0.0, 1.0, 25.0, 50.0, 90.0, 95.0, 99.0, 99.9, 100.0):
        assert hp.percentile(q) == hj.percentile(q)
    assert hp.summary() == hj.summary()


def test_registry_snapshot_matches_reference():
    rng = np.random.default_rng(7)
    regs = (p_metrics.MetricsRegistry(), j_metrics.MetricsRegistry())
    for value in rng.exponential(40.0, 200):
        for reg in regs:
            reg.counter("dispatch.launches").inc()
            reg.histogram("dispatch.launch_us.scale.vector").observe(value)
            reg.gauge("queue.depth").set(value // 10)
    assert regs[0].snapshot() == regs[1].snapshot()
    with pytest.raises(TypeError):
        regs[0].gauge("dispatch.launches")
    with pytest.raises(ValueError):
        regs[0].counter("c").inc(-1)


@pytest.mark.parametrize("level,msg,fields", [
    ("warning", "skipping non-record file", {"dir": "runs", "file": "x"}),
    ("info", "sweep", {"kernel": "scale", "n": 3, "share": 0.91}),
    ("error", "no fields", {}),
])
def test_log_lines_match_reference(level, msg, fields):
    got = p_log.LogRecord(level, msg, fields).render()
    assert got == j_log.LogRecord(level, msg, fields).render()
    out = io.StringIO()
    logger = p_log.StructuredLogger(level="info", stream=out)
    with logger.capture() as records:
        logger.log(level, msg, **fields)
    assert records[0].render() == got
    assert out.getvalue() == (got + "\n" if logger.enabled_for(level)
                              else "")


def test_logger_levels_and_quiet_default():
    out = io.StringIO()
    logger = p_log.StructuredLogger(stream=out)
    with logger.capture() as records:
        logger.debug("hidden", a=1)
        logger.warning("shown", b=2)
    assert [r.level for r in records] == ["debug", "warning"]
    assert out.getvalue() == "[repro:warning] shown b=2\n"
    with pytest.raises(ValueError):
        logger.configure(level="loud")
    assert p_log.LEVELS == j_log.LEVELS


def test_time_fn_spans_are_its_samples():
    x = torch.ones(50_000)
    with p_trace.capture() as view:
        t = time_fn(lambda: x * 2.0, warmup=1, iters=9, label="probe",
                    layer="bench", kernel="scale")
    spans = [e for e in view.events if e.name == "probe"]
    assert len(spans) == t.iters == 9
    assert [e.attrs["iter"] for e in spans] == list(range(9))
    assert all(e.attrs["kernel"] == "scale" and e.layer == "bench"
               for e in spans)
    assert abs(statistics.median(e.dur_us for e in spans)
               - t.median_us) <= 0.051
    assert [round(e.dur_us, 6) for e in spans] == \
        [round(s, 6) for s in t.samples_us]


def test_tracer_off_emits_nothing():
    op = p_registry.get("scale")
    args, kw = op.make_inputs(np.random.default_rng(0), 1000, device="cpu")
    before = len(p_trace.TRACER.events)
    assert not p_trace.TRACER.enabled
    op(*args, backend="plain", **kw)
    time_fn(lambda: args[0] * 2.0, iters=3)
    assert len(p_trace.TRACER.events) == before


def _launch_spans(view):
    return {e.name: e for e in view.events
            if e.name in ("dispatch", "launch")}


@pytest.mark.parametrize("engine", ["vector", "matrix"])
@pytest.mark.parametrize("name", NAMES)
def test_launch_span_matches_reference(name, engine):
    from repro_torch.carry import from_numpy
    jop = j_registry.get(name)
    jargs, jkw = jop.make_inputs(np.random.default_rng(0), jop.test_size)
    pargs, pkw = from_numpy(jargs, jkw, device="cpu")
    with j_trace.capture() as jview:
        jop(*jargs, engine=engine, **jkw)
    with p_trace.capture() as pview:
        p_registry.get(name)(*pargs, engine=engine, backend="plain", **pkw)
    j_spans, p_spans = _launch_spans(jview), _launch_spans(pview)
    for span in ("dispatch", "launch"):
        assert sorted(p_spans[span].attrs) == sorted(j_spans[span].attrs)
        for key in ("kernel", "engine", "dtype"):
            assert p_spans[span].attrs[key] == j_spans[span].attrs[key]
    for key in ("traffic_bytes", "work_flops"):
        assert p_spans["launch"].attrs[key] == j_spans["launch"].attrs[key]
    launch = p_spans["launch"]
    assert launch.depth == p_spans["dispatch"].depth + 1
    assert p_trace.TRACER.events[launch.parent].name == "dispatch"
    assert launch.attrs["measured_us"] > 0
