"""The serving and model-verdict claims and the compare gate, against the
reference's ``repro.report`` and ``benchmarks/compare.py``.

* On the committed serving record sets the port's ``check_records``
  gives the reference's ``(claim, passed, detail)`` list, record for
  record, the online-tuned sets' ``online_ceiling`` included, and so do
  sessions charged on the measured mesh.
* The online regret gate gives the reference's failure lists on joined
  online pairs.
* On the baseline / candidate directories the reference's own tests
  build, ``repro_torch.bench.compare`` gives the reference's pass / fail
  and failure list, message for message, the measured-mesh gate on the
  reference's ``--real`` sweeps included.
* A port record is gated on the kernel's ``us_per_call``, not the
  oracle's ``ref_us_per_call``.
"""
import json
import pathlib
import shutil

import pytest

pytest.importorskip("torch")

from benchmarks import compare as j_compare  # noqa: E402
from repro.report import check_records as j_check_records  # noqa: E402
from repro.report import load_dir as j_load_dir  # noqa: E402

from repro_torch.bench import compare as p_compare  # noqa: E402
from repro_torch.report import (MODEL_CLAIMS, ONLINE_CLAIMS,  # noqa: E402
                                SERVING_CLAIMS, TRACE_CLAIMS, check_records,
                                check_serving_record, hw_for, load_dir,
                                violations)

REPO = pathlib.Path(__file__).resolve().parent.parent
RUNS = REPO / "runs"
SERVING = ("scale", "triad", "axpy", "lm-deepseek-7b", "lm-mamba2-780m",
           "lm-qwen3-moe-235b-a22b")


def _triples(results):
    return [(r.claim, r.passed, r.detail) for r in results]


def _copy(tmp_path, *names):
    for name in names:
        shutil.copy(RUNS / f"BENCH_serve_{name}.json", tmp_path)
    return str(tmp_path)


# -- serving and model claims ------------------------------------------------

@pytest.mark.parametrize("name", SERVING)
def test_serving_claims_match_reference_record_for_record(tmp_path, name):
    d = _copy(tmp_path, name)
    got = check_records(load_dir(d))
    want = j_check_records(j_load_dir(d))
    assert _triples(got) == _triples(want)
    assert [(r.record.engine, r.record.workload) for r in got] == \
        [(r.record.engine, r.record.workload) for r in want]
    assert not violations(got)
    claims = SERVING_CLAIMS + (MODEL_CLAIMS if name.startswith("lm-")
                               else ()) + TRACE_CLAIMS
    per_record = len(got) // 2
    assert tuple(r.claim for r in got[:per_record]) == claims


def test_all_committed_serving_sets_at_once(tmp_path):
    d = _copy(tmp_path, *SERVING)
    assert _triples(check_records(load_dir(d))) == \
        _triples(j_check_records(j_load_dir(d)))


def _edit(rec, how):
    if how == "mxu_ceiling":
        rec["mxu_ceiling"] = 9.0
    elif how == "engine_auto":
        rec["engine_auto"] = "matrix"
    elif how == "memory_bound":
        rec["memory_bound"] = False
    elif how == "p99_ms":
        rec["p99_ms"] = rec["p50_ms"] / 2
    elif how == "goodput_rps":
        rec["goodput_rps"] = 10 * rec["goodput_rps"] + 100
    elif how == "batch_spans":
        rec["trace"]["batch_spans"] += 1
    elif how == "span_compute_ms":
        rec["trace"]["span_compute_ms"] += 1.0
    elif how == "verdict_intensity":
        rec["verdict"]["ops"][0]["intensity"] += 1.0
    elif how == "verdict_time":
        rec["verdict"]["step_time_ms"] *= 2
    else:  # a memory-bound op routed to the matrix engine
        rec["verdict"]["ops"][0]["engine"] = "matrix"


@pytest.mark.parametrize("name,how,claim", [
    ("scale", "mxu_ceiling", "ceiling"),
    ("scale", "engine_auto", "routing"),
    ("triad", "memory_bound", "boundedness"),
    ("axpy", "p99_ms", "percentiles"),
    ("scale", "goodput_rps", "goodput"),
    ("triad", "batch_spans", "trace_reconciliation"),
    ("axpy", "span_compute_ms", "trace_reconciliation"),
    ("lm-deepseek-7b", "verdict_intensity", "model_verdict"),
    ("lm-deepseek-7b", "verdict_time", "model_verdict"),
    ("lm-mamba2-780m", "verdict_engine", "model_verdict"),
])
def test_edited_session_fails_the_same_claim(tmp_path, name, how, claim):
    payload = json.loads((RUNS / f"BENCH_serve_{name}.json").read_text())
    _edit(payload["records"][1], how)
    (tmp_path / f"BENCH_serve_{name}.json").write_text(json.dumps(payload))
    got = check_records(load_dir(str(tmp_path)))
    want = j_check_records(j_load_dir(str(tmp_path)))
    assert _triples(got) == _triples(want)
    bad = violations(got)
    assert claim in {r.claim for r in bad}
    assert {r.record.engine for r in bad} == \
        {payload["records"][1]["engine"]}


@pytest.mark.parametrize("name,mode", [
    pytest.param("BENCH_serve_scale.json", "mesh",
                 id="BENCH_serve_scale.json-item 13.3"),
])
def test_serving_sets_needing_unported_claims_raise(tmp_path, name, mode):
    """A session set charged on the measured mesh verifies as the
    reference verifies it, and passes the gate against itself."""
    payload = json.loads((RUNS / name).read_text())
    for rec in payload["records"]:
        rec["num_shards"], rec["mesh_exec_mode"] = 2, mode
    (tmp_path / name).write_text(json.dumps(payload))
    got = check_records(load_dir(str(tmp_path)))
    assert _triples(got) == _triples(j_check_records(j_load_dir(
        str(tmp_path))))
    assert not violations(got)
    assert p_compare.compare(str(tmp_path), str(tmp_path)) == []


def test_chaos_set_matches_reference_verdicts(tmp_path):
    """The reference's chaos session set (2-way mesh, events block)
    passes the port's claims, elastic_integrity included, with the
    reference's verdicts and details."""
    shutil.copy(RUNS / "BENCH_serve_scale_mesh2.json", tmp_path)
    got = check_records(load_dir(str(tmp_path)))
    want = j_check_records(j_load_dir(str(tmp_path)))
    assert _triples(got) == _triples(want)
    assert "elastic_integrity" in {r.claim for r in got}
    assert not violations(got)


@pytest.mark.parametrize("name", ["scale", "axpy"])
def test_online_sets_match_reference_verdicts(tmp_path, name):
    shutil.copy(RUNS / f"BENCH_serve_{name}_online.json", tmp_path)
    got = check_records(load_dir(str(tmp_path)))
    want = j_check_records(j_load_dir(str(tmp_path)))
    assert _triples(got) == _triples(want)
    online = [r for r in got if r.claim in ONLINE_CLAIMS]
    assert len(online) == 1 and online[0].passed
    assert "decisions replayed" in online[0].detail


def _online_payload(name="scale"):
    return json.loads(
        (RUNS / f"BENCH_serve_{name}_online.json").read_text())


def _tamper_events(payload):
    """Swap two logged arms: the recorded sequence no longer replays."""
    (key,) = payload["records"][0]["tuning"]["keys"]
    events = payload["records"][0]["tuning"]["keys"][key]["events"]
    events[1]["arm"], events[2]["arm"] = events[2]["arm"], events[1]["arm"]


def _tamper_engine(payload):
    """Tune a memory-bound kernel on the matrix engine."""
    t = payload["records"][0]["tuning"]
    (key,) = t["keys"]
    kd = t["keys"].pop(key)
    kd["engine"] = "matrix"
    t["keys"][key.replace("|vector|", "|matrix|")] = kd


@pytest.mark.parametrize("tamper", [_tamper_events, _tamper_engine])
def test_tampered_online_record_fails_as_in_reference(tmp_path, tamper):
    payload = _online_payload()
    tamper(payload)
    (tmp_path / "BENCH_serve_scale_online.json").write_text(
        json.dumps(payload))
    got = check_records(load_dir(str(tmp_path)))
    assert _triples(got) == _triples(j_check_records(j_load_dir(
        str(tmp_path))))
    assert [r.claim for r in violations(got)] == ["online_ceiling"]


def _scaled_regret(factor):
    def edit(payload):
        t = payload["records"][0]["tuning"]
        t["regret_us_total"] = round(t["regret_us_total"] * factor, 3)
    return edit


def _other_budget(payload):
    payload["records"][0]["tuning"]["budget"] = 4


ONLINE_CANDIDATES = {
    "identical": lambda payload: None,
    "more_regret": _scaled_regret(2.0),
    "less_regret": _scaled_regret(0.5),
    "budget": _other_budget,
    "dropped": None,
}


@pytest.mark.parametrize("threshold", [0.25, 5.0])
@pytest.mark.parametrize("case", sorted(ONLINE_CANDIDATES))
def test_regret_gate_matches_reference(tmp_path, case, threshold):
    base, cand = _dirs(tmp_path)
    for name in ("scale", "axpy"):
        shutil.copy(RUNS / f"BENCH_serve_{name}_online.json", base)
    shutil.copy(RUNS / "BENCH_serve_axpy_online.json", cand)
    if ONLINE_CANDIDATES[case] is not None:
        payload = _online_payload()
        ONLINE_CANDIDATES[case](payload)
        (cand / "BENCH_serve_scale_online.json").write_text(
            json.dumps(payload))
    msgs = _both(base, cand, threshold=threshold)
    got = p_compare.gate(str(base), str(cand), threshold=threshold)
    want = j_compare.gate(str(base), str(cand), threshold=threshold)
    assert got.summary_table() == want.summary_table()
    if case == "identical":
        assert msgs == ""
    elif case == "more_regret":
        # the edited total no longer sums its events: a claim violation
        # at any threshold, and a regret regression past 25%
        assert "[online_ceiling]" in msgs
        assert ("perf regression" in msgs) == (threshold < 1)
    elif case == "budget":
        assert "config mismatch" in msgs and "tune_budget=8 vs 4" in msgs
    elif case == "dropped":
        assert "missing: serving" in msgs


def test_sharded_session_without_events_raises(tmp_path):
    """A sharded session charged on the measured mesh, and the same
    session on the virtual clock, each verify as the reference verifies
    them."""
    payload = json.loads((RUNS / "BENCH_serve_scale.json").read_text())
    payload["records"][0]["num_shards"] = 2
    for mode in ("mesh", "virtual"):
        payload["records"][0]["mesh_exec_mode"] = mode
        (tmp_path / "BENCH_serve_scale.json").write_text(
            json.dumps(payload))
        (rs,) = load_dir(str(tmp_path))
        assert check_serving_record(rs.records[0], hw_for(rs))
        got = check_records(load_dir(str(tmp_path)))
        want = j_check_records(j_load_dir(str(tmp_path)))
        assert _triples(got) == _triples(want)
        assert not violations(got)


def test_serving_set_with_unknown_hw_model_raises(tmp_path):
    payload = json.loads((RUNS / "BENCH_serve_scale.json").read_text())
    payload["env"]["hw_model"] = "TPU-v4"
    (tmp_path / "BENCH_serve_scale.json").write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="unknown hw_model"):
        check_records(load_dir(str(tmp_path)))


# -- the compare gate: the reference's directories ---------------------------

def _serving_raw(**overrides):
    """tests/test_serving.py's healthy schema-4 serving record."""
    rec = {
        "kernel": "scale", "engine": "vector", "engine_auto": "vector",
        "workload": "poisson", "rate_rps": 64.0, "duration_s": 2.0,
        "size": 65536, "dtype": "float32", "seed": 0,
        "offered": 100, "completed": 100, "batches": 30,
        "mean_batch": 3.3, "p50_ms": 10.0, "p95_ms": 20.0,
        "p99_ms": 25.0, "queue_p50_ms": 5.0, "queue_p99_ms": 12.0,
        "compute_p50_ms": 5.0, "compute_p99_ms": 13.0,
        "throughput_rps": 50.0, "goodput_rps": 50.0, "slo_ms": 50.0,
        "slo_attainment": 1.0, "intensity": 0.125,
        "memory_bound": True, "mxu_ceiling": 1.0,
    }
    rec.update(overrides)
    return rec


def _write_serving(path, records):
    payload = {"schema": 4, "kind": "serving", "kernel": "scale",
               "env": {"jax": "0", "device": "cpu", "interpret": True,
                       "hw_model": "TPU-v5e"},
               "records": records}
    path.write_text(json.dumps(payload))


def _raw(**overrides):
    """tests/test_bench_common.py's bench sweep point."""
    rec = {
        "kernel": "scale", "engine": "vector", "size": 1024,
        "dtype": "float32", "ref_us_per_call": 100.0, "max_err": 0.0,
        "intensity": 0.125, "memory_bound": True,
        "engine_auto": "vector", "mxu_ceiling": 1.0,
    }
    rec.update(overrides)
    return rec


def _write_set(path, records, kernel="scale"):
    payload = {"schema": 2, "kernel": kernel,
               "env": {"hw_model": "TPU-v5e"}, "records": records}
    path.write_text(json.dumps(payload))


def _dirs(tmp_path):
    base, cand = tmp_path / "base", tmp_path / "cand"
    base.mkdir(), cand.mkdir()
    return base, cand


def _both(base, cand, **kw):
    got = p_compare.compare(str(base), str(cand), **kw)
    want = j_compare.compare(str(base), str(cand), **kw)
    assert got == want
    return "\n".join(got)


SERVING_CANDIDATES = {
    "identical": [_serving_raw(), _serving_raw(engine="matrix")],
    # p99 blow-up + goodput collapse + a dropped session
    "regressed": [_serving_raw(p99_ms=100.0, goodput_rps=10.0,
                               slo_attainment=0.2)],
    # sessions under different load knobs refuse to compare at all
    "knobs": [_serving_raw(rate_rps=32.0), _serving_raw(engine="matrix")],
    "policy": [_serving_raw(max_batch=4, max_wait_ms=20.0),
               _serving_raw(engine="matrix")],
    # a claim violation in an otherwise identical candidate
    "claim": [_serving_raw(mxu_ceiling=9.0), _serving_raw(engine="matrix")],
    # speed-ups never fail the gate
    "faster": [_serving_raw(p99_ms=12.0, p95_ms=11.0),
               _serving_raw(engine="matrix")],
}


@pytest.mark.parametrize("threshold", [0.25, 100.0])
@pytest.mark.parametrize("kind", ["serving", "all", "bench"])
@pytest.mark.parametrize("case", sorted(SERVING_CANDIDATES))
def test_serving_gate_matches_reference(tmp_path, case, kind, threshold):
    base, cand = _dirs(tmp_path)
    _write_serving(base / "BENCH_serve_scale.json",
                   [_serving_raw(), _serving_raw(engine="matrix")])
    _write_serving(cand / "BENCH_serve_scale.json",
                   SERVING_CANDIDATES[case])
    msgs = _both(base, cand, kind=kind, threshold=threshold)
    if kind == "bench":
        assert "empty comparison" in msgs
    elif case in ("identical", "faster"):
        assert msgs == ""
    elif case == "regressed":
        assert "missing: serving" in msgs
        assert ("perf regression" in msgs) == (threshold < 1)
        assert ("goodput drop" in msgs) == (threshold < 1)
    elif case in ("knobs", "policy"):
        assert "config mismatch" in msgs
    else:
        assert "claim violation" in msgs and "[ceiling]" in msgs


BENCH_CANDIDATES = {
    "identical": ([_raw(), _raw(engine="matrix")], []),
    # >25% slower + a dropped sweep point + a claim violation
    "regressed": ([_raw(ref_us_per_call=200.0, mxu_ceiling=1.9)], []),
    "faster": ([_raw(ref_us_per_call=50.0), _raw(engine="matrix")], []),
    # tests/test_bench_common.py: scale slower and dropped, triad a claim
    "two_kernels": ([_raw(ref_us_per_call=300.0)],
                    [_raw(kernel="triad", mxu_ceiling=1.9)]),
}


@pytest.mark.parametrize("kernels", [None, ["triad"], ["scale"]])
@pytest.mark.parametrize("threshold", [0.25, 2.0])
@pytest.mark.parametrize("case", sorted(BENCH_CANDIDATES))
def test_bench_gate_matches_reference(tmp_path, case, threshold, kernels):
    base, cand = _dirs(tmp_path)
    _write_set(base / "BENCH_scale.json", [_raw(), _raw(engine="matrix")])
    _write_set(base / "BENCH_triad.json", [_raw(kernel="triad")],
               kernel="triad")
    scale, triad = BENCH_CANDIDATES[case]
    _write_set(cand / "BENCH_scale.json", scale)
    _write_set(cand / "BENCH_triad.json", triad or [_raw(kernel="triad")],
               kernel="triad")
    _both(base, cand, threshold=threshold, kernels=kernels)
    got = p_compare.gate(str(base), str(cand), threshold=threshold,
                         kernels=kernels)
    want = j_compare.gate(str(base), str(cand), threshold=threshold,
                          kernels=kernels)
    assert [(f.kind, f.kernel) for f in got.failures] == \
        [(f.kind, f.kernel) for f in want.failures]
    assert got.compared == want.compared
    assert got.summary_table() == want.summary_table()


def test_unknown_kind_raises(tmp_path):
    base, cand = _dirs(tmp_path)
    _write_set(base / "BENCH_scale.json", [_raw()])
    _write_set(cand / "BENCH_scale.json", [_raw()])
    with pytest.raises(ValueError, match="unknown kind"):
        p_compare.compare(str(base), str(cand), kind="nope")


@pytest.mark.parametrize("identical", [True, False])
def test_main_matches_reference_exit_and_table(tmp_path, capsys, identical):
    base, cand = _dirs(tmp_path)
    _write_set(base / "BENCH_scale.json", [_raw(), _raw(engine="matrix")])
    _write_set(cand / "BENCH_scale.json",
               [_raw(), _raw(engine="matrix")] if identical else [_raw()])
    want_rc = j_compare.main([str(base), str(cand)])
    want = capsys.readouterr()
    assert p_compare.main([str(base), str(cand)]) == want_rc == \
        (0 if identical else 1)
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)


def test_committed_runs_gate_against_themselves(tmp_path):
    d = tmp_path / "runs"
    d.mkdir()
    for name in ("attention", "axpy", "scale", "spmv", "stencil", "triad"):
        shutil.copy(RUNS / f"BENCH_{name}.json", d)
    _copy(d, *SERVING)
    assert p_compare.compare(str(d), str(d)) == \
        j_compare.compare(str(d), str(d)) == []


# -- what the port gates differently, and what it refuses ---------------------

def _port_point(us, ref_us):
    """A port sweep point: the kernel's median beside the oracle's."""
    return _raw(us_per_call=us, ref_us_per_call=ref_us)


@pytest.mark.parametrize("cand_us,cand_ref,failed", [
    (300.0, 1000.0, True),    # the kernel 3x slower, the oracle the same
    (100.0, 3000.0, False),   # only the oracle slower: no regression
    (110.0, 1000.0, False),   # within the threshold
])
def test_port_records_gate_the_kernel_median(tmp_path, cand_us, cand_ref,
                                             failed):
    base, cand = _dirs(tmp_path)
    _write_set(base / "BENCH_scale.json", [_port_point(100.0, 1000.0)])
    _write_set(cand / "BENCH_scale.json", [_port_point(cand_us, cand_ref)])
    msgs = "\n".join(p_compare.compare(str(base), str(cand)))
    assert ("perf regression" in msgs) == failed
    if failed:
        assert "us_per_call 100.0 -> 300.0" in msgs
        assert "ref_us_per_call" not in msgs


def test_engine_and_oracle_medians_never_gate_each_other(tmp_path):
    base, cand = _dirs(tmp_path)
    _write_set(base / "BENCH_scale.json", [_raw()])
    _write_set(cand / "BENCH_scale.json", [_port_point(100.0, 100.0)])
    msgs = p_compare.compare(str(base), str(cand))
    assert len(msgs) == 1 and "config mismatch" in msgs[0]
    assert "baseline times ref_us_per_call, candidate us_per_call" in msgs[0]


#: Flash-decode's two STREAM points: one cache length S, so one size, and
#: K of [B, S, KH, Dh] at G = 4 (Mistral-NeMo) and G = 16 (Qwen3-MoE).
_ATTN_SHAPES = {4: [4, 32768, 8, 128], 16: [4, 32768, 4, 128]}


def _attn_point(g, engine, dtype, us):
    return _raw(kernel="attention", engine=engine, dtype=dtype, size=32768,
                intensity=2.0, shape=_ATTN_SHAPES[g], us_per_call=us,
                ref_us_per_call=1000.0)


def _attn_set(path, times):
    """A BENCH_attention set of {g: us} per engine and dtype."""
    _write_set(path, [_attn_point(g, e, d, us) for g, us in times.items()
                      for e in ("vector", "matrix")
                      for d in ("float32", "bfloat16")], kernel="attention")


def test_flash_decode_points_of_one_size_keep_their_own_keys(tmp_path,
                                                             capsys):
    base, cand = _dirs(tmp_path)
    # the parent's set holds G = 4 only; the candidate adds a G = 16 point
    # three times slower at the same size, which must gate nothing
    _attn_set(base / "BENCH_attention.json", {4: 100.0})
    _attn_set(cand / "BENCH_attention.json", {4: 100.0, 16: 300.0})
    index = p_compare._index(load_dir(str(cand)), "bench")
    assert len(index) == 8
    for engine in ("vector", "matrix"):
        for dtype in ("float32", "bfloat16"):
            keys = [k for k in index if k[1:4] == (engine, 32768, dtype)]
            assert sorted(k[5] for k in keys) == ["4x32768x4x128",
                                                  "4x32768x8x128"]
            assert {index[k].us_per_call for k in keys} == {100.0, 300.0}
    assert p_compare.compare(str(base), str(cand)) == []
    notes = capsys.readouterr().out.splitlines()
    assert len(notes) == 4
    assert all(n.startswith("note: new sweep point attention/")
               and n.endswith("/4x32768x4x128") for n in notes)
    # the G = 4 point three times slower fails on its own key only
    _attn_set(cand / "BENCH_attention.json", {4: 300.0, 16: 100.0})
    msgs = p_compare.compare(str(base), str(cand))
    assert len(msgs) == 4
    assert all("perf regression" in m and "/4x32768x8x128 " in m
               for m in msgs)


@pytest.mark.parametrize("name", [
    pytest.param("BENCH_scale_mesh2.json",
                 id="BENCH_scale_mesh2.json-item 13"),
    pytest.param("BENCH_stencil_mesh2.json",
                 id="BENCH_stencil_mesh2.json-item 13.3"),
])
def test_gates_not_ported_raise(tmp_path, name):
    """The measured-mesh gate on the reference's ``--real`` sweeps: a set
    passes against itself, and a candidate whose mesh wall or skew
    regressed fails with the reference's messages."""
    base, cand = _dirs(tmp_path)
    shutil.copy(RUNS / name, base)
    shutil.copy(RUNS / name, cand)
    assert p_compare.compare(str(base), str(cand)) == []
    assert j_compare.compare(str(base), str(cand)) == []
    payload = json.loads((RUNS / name).read_text())
    mex = payload["records"][0]["mesh_exec"]
    mex["mesh_wall_us"] *= 2
    mex["skew"] *= 2
    (cand / name).write_text(json.dumps(payload))
    msgs = p_compare.compare(str(base), str(cand))
    assert msgs == j_compare.compare(str(base), str(cand))
    assert any("mesh_wall_us" in m for m in msgs)
    assert any("mesh_skew" in m for m in msgs)


def test_serve_cli_records_pass_the_gate(tmp_path):
    from repro_torch.bench import run as bench_run
    out = tmp_path / "serve"
    with pytest.raises(SystemExit) as stop:
        bench_run.main(["serve", "--device", "cpu", "--size", "4096",
                        "--duration", "0.2", "--out", str(out)])
    assert stop.value.code == 0
    sets = load_dir(str(out))
    assert sorted(rs.kernel for rs in sets) == ["axpy", "scale", "triad"]
    assert all(rs.kind == "serving" for rs in sets)
    results = check_records(sets)
    assert results and not violations(results)
    assert p_compare.compare(str(out), str(out)) == []


def test_serve_cli_lm_records_verify(tmp_path):
    from repro_torch.bench import serve
    out = tmp_path / "lm"
    trace = tmp_path / "trace.json"
    assert serve.main(["--workload", "lm", "--device", "cpu", "--out",
                       str(out), "--trace-out", str(trace)]) == 0
    (rs,) = load_dir(str(out))
    assert rs.kernel == "lm-deepseek-7b" and rs.env["device"] == "cpu"
    assert [r.engine for r in rs.records] == ["vector", "matrix"]
    results = check_records([rs])
    assert not violations(results)
    assert "model_verdict" in {r.claim for r in results}
    from repro_torch.obs.trace import read_chrome_trace, validate_chrome_trace
    assert validate_chrome_trace(read_chrome_trace(str(trace))) == []


@pytest.mark.parametrize("argv,item", [
    pytest.param(["--online-tune", "--workload", "lm"],
                 "kernel sessions only", id="argv3-kernel sessions only"),
    pytest.param(["--real"], "requires --mesh N", id="argv5-item 13"),
    pytest.param(["--slo-route"], "requires --online-tune",
                 id="slo-route-alone"),
    pytest.param(["--online-tune", "--mesh", "2"], "owns the mesh width",
                 id="online-mesh"),
    pytest.param(["--chaos", "fail@0.1:1", "--workload", "closed"],
                 "open-loop", id="chaos-closed"),
    pytest.param(["--chaos", "fail@0.1:1", "--workload", "lm"],
                 "kernel sessions only", id="chaos-lm"),
    pytest.param(["--chaos", "boom@0.1"], "bad --chaos spec",
                 id="chaos-bad-spec"),
])
def test_serve_cli_refuses_what_waits(argv, item):
    from repro_torch.bench import serve
    with pytest.raises(SystemExit, match=item):
        serve.main(["--device", "cpu"] + argv)


def test_serve_cli_online_tune_persists_and_gates(tmp_path):
    """--tuned loads a cache the bandit warm-starts from; the online
    sessions' records pass every claim and gate against themselves with
    the regret gate, and tuned-online.json adds their winners to the
    loaded entries."""
    from repro_torch.bench import serve
    from repro_torch.core.dispatch import DEFAULT_DISPATCHER
    from repro_torch.tuning import TunedEntry, TuningCache
    hw = DEFAULT_DISPATCHER.hw.name
    tuned = str(tmp_path / "tuned.json")
    warm = {"block_rows": 512, "lanes": 512}
    # a kernel time no batch wall can beat: the loaded entry survives
    TuningCache([TunedEntry("scale", "vector", "float32", hw, warm, 0.001,
                            0.002, 2**26)]).save(tuned)
    out = tmp_path / "serve"
    try:
        assert serve.main(["--device", "cpu", "--size", "4096",
                           "--duration", "0.2", "--kernels", "scale,axpy",
                           "--online-tune", "--tune-budget", "3",
                           "--tuned", tuned, "--out", str(out)]) == 0
    finally:
        DEFAULT_DISPATCHER.set_tuning_cache(None)
    names = sorted(p.name for p in out.iterdir())
    assert names == ["BENCH_serve_axpy.json", "BENCH_serve_axpy_online.json",
                     "BENCH_serve_scale.json",
                     "BENCH_serve_scale_online.json", "tuned-online.json"]
    sets = load_dir(str(out))
    assert not violations(check_records(sets))
    (scale,) = [rs for rs in sets if rs.path.endswith("scale_online.json")]
    kd = scale.records[0].tuning["keys"]["scale|vector|float32|full"]
    assert kd["warm_source"] == "cache" and kd["arms"][0] == warm
    assert kd["committed_us"] == 0.001
    assert p_compare.compare(str(out), str(out)) == []
    persisted = TuningCache.load(str(out / "tuned-online.json"))
    got = {(e.kernel, e.source) for e in persisted}
    assert got == {("scale", "cuda"), ("axpy", "online")}


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_launch_serve_on_the_cpu(capsys, arch):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", arch, "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3",
                       "--rate", "8", "--duration", "0.5"])
    out = capsys.readouterr().out
    assert "served" in out and "goodput" in out and "p99" in out
