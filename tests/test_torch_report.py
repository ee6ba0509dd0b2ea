"""The port's claims layer against the reference's ``repro.report``.

* Over the committed single-device reference records, the port's
  ``load_dir`` + ``check_records`` give the reference's
  ``(claim, passed, detail)`` list, record for record.
* A hand-edited record fails the same claim in both packages.
* Where the reference passes silently the port refuses: an unknown
  ``hw_model`` raises.  The reference's measured-mesh sweeps
  (``mesh_exec``) get its verdicts, ``collective_cost`` and ``mesh_skew``
  included.
* The shard claims (``shard_ceiling``, ``shard_traffic``) give the
  reference's verdicts on the same schema-5 records, hand-edited ones
  included, and the sharded section renders.
"""
import json
import pathlib
import shutil

import pytest

pytest.importorskip("torch")

from repro.report import check_records as j_check_records  # noqa: E402
from repro.report import load_dir as j_load_dir  # noqa: E402

from repro_torch.obs.log import LOG  # noqa: E402
from repro_torch.report import (TOLERANCE, check_records, hw_for,  # noqa: E402
                                load_dir, load_file, violations)

REPO = pathlib.Path(__file__).resolve().parent.parent
RUNS = REPO / "runs"
NAMES = ("attention", "axpy", "scale", "spmv", "stencil", "triad")


def _triples(results):
    return [(r.claim, r.passed, r.detail) for r in results]


def _dir_with(tmp_path, *names):
    for name in names:
        shutil.copy(RUNS / f"BENCH_{name}.json", tmp_path)
    return str(tmp_path)


@pytest.mark.parametrize("name", NAMES)
def test_claims_match_reference_record_for_record(tmp_path, name):
    d = _dir_with(tmp_path, name)
    got = check_records(load_dir(d))
    want = j_check_records(j_load_dir(d))
    assert _triples(got) == _triples(want)
    assert [(r.record.engine, r.record.size, r.record.dtype) for r in got] \
        == [(r.record.engine, r.record.size, r.record.dtype) for r in want]
    assert not violations(got)
    assert {r.claim for r in got} == {"ceiling", "routing", "accuracy",
                                      "boundedness", "trace_reconciliation"}


def test_all_six_families_at_once(tmp_path):
    d = _dir_with(tmp_path, *NAMES)
    assert _triples(check_records(load_dir(d))) == \
        _triples(j_check_records(j_load_dir(d)))


def _edit(rec, how):
    if how == "mxu_ceiling":
        rec["mxu_ceiling"] = 1.9
    elif how == "engine_auto":
        rec["engine_auto"] = "matrix"
    elif how == "max_err":
        rec["max_err"] = 2 * TOLERANCE[rec["dtype"]]
    elif how == "span_median_us":
        rec["trace"]["span_median_us"] += 1.0
    else:  # roofline gauge
        rec["trace"]["roofline"]["achieved_gbs"] *= 2


@pytest.mark.parametrize("how,claim", [
    ("mxu_ceiling", "ceiling"), ("engine_auto", "routing"),
    ("max_err", "accuracy"), ("span_median_us", "trace_reconciliation"),
    ("roofline", "trace_reconciliation"),
])
def test_edited_record_fails_the_same_claim(tmp_path, how, claim):
    payload = json.loads((RUNS / "BENCH_scale.json").read_text())
    _edit(payload["records"][1], how)
    (tmp_path / "BENCH_scale.json").write_text(json.dumps(payload))
    got = check_records(load_dir(str(tmp_path)))
    want = j_check_records(j_load_dir(str(tmp_path)))
    assert _triples(got) == _triples(want)
    bad = violations(got)
    assert [r.claim for r in bad] == [claim]
    assert bad[0].record.size == payload["records"][1]["size"]


def test_engine_median_is_what_a_port_record_reconciles(tmp_path):
    """A record with ``us_per_call`` reconciles the trace against it, and
    the detail says so."""
    payload = json.loads((RUNS / "BENCH_scale.json").read_text())
    rec = payload["records"][0]
    med = rec["trace"]["span_median_us"]
    rec["us_per_call"] = med
    rec["trace"]["clock"] = "cuda_event"
    rec["trace"]["roofline"]["measured_us"] = med
    (tmp_path / "BENCH_scale.json").write_text(json.dumps(payload))
    results = check_records(load_dir(str(tmp_path)))
    trace = [r for r in results if r.claim == "trace_reconciliation"]
    assert "vs engine" in trace[0].detail
    # the roofline gauge was derived from the oracle's time: it fails
    # against the engine's median, as it must
    assert not trace[0].passed and "achieved_gbs" in trace[0].detail
    rec["trace"]["clock"] = "host"
    (tmp_path / "BENCH_scale.json").write_text(json.dumps(payload))
    detail = [r for r in check_records(load_dir(str(tmp_path)))
              if r.claim == "trace_reconciliation"][0].detail
    assert "bench trace on clock 'host'" in detail


@pytest.mark.parametrize("hw_model", ["", "TPU-v4", "H200"])
def test_unknown_hw_model_raises(tmp_path, hw_model):
    payload = json.loads((RUNS / "BENCH_triad.json").read_text())
    payload["env"]["hw_model"] = hw_model
    (tmp_path / "BENCH_triad.json").write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="unknown hw_model"):
        check_records(load_dir(str(tmp_path)))
    # where the reference falls back to the TPU v5e
    assert not [r for r in j_check_records(j_load_dir(str(tmp_path)))
                if not r.passed]


@pytest.mark.parametrize("hw_model", ["H100-SXM5", "H100-PCIe", "H100-NVL",
                                      "A100-80GB", "GH200", "TPU-v5e"])
def test_known_hw_models_resolve(tmp_path, hw_model):
    payload = json.loads((RUNS / "BENCH_triad.json").read_text())
    payload["env"]["hw_model"] = hw_model
    (tmp_path / "BENCH_triad.json").write_text(json.dumps(payload))
    (rs,) = load_dir(str(tmp_path))
    assert hw_for(rs).name == hw_model


@pytest.mark.parametrize("name", [
    pytest.param("BENCH_scale_mesh2.json",
                 id="BENCH_scale_mesh2.json-item 13"),
    pytest.param("BENCH_stencil_mesh2.json",
                 id="BENCH_stencil_mesh2.json-item 13"),
])
def test_sets_needing_unported_claims_raise(tmp_path, name):
    """The reference's ``--real`` sweeps: the port's verdicts are the
    reference's, the mesh claims included, and a record whose collective
    was made free or whose skew left the band fails them."""
    shutil.copy(RUNS / name, tmp_path)
    got = check_records(load_dir(str(tmp_path)))
    assert [(r.claim, r.passed, r.detail) for r in got] == \
        [(r.claim, r.passed, r.detail)
         for r in j_check_records(j_load_dir(str(tmp_path)))]
    assert {"collective_cost", "mesh_skew"} <= {r.claim for r in got}
    assert not violations(got)
    payload = json.loads((RUNS / name).read_text())
    mex = payload["records"][0]["mesh_exec"]
    if mex["collective_us"] > 0:
        mex["collective_us"] = 0.0
        claim = "collective_cost"
    else:
        mex["skew"] = 1e4
        claim = "mesh_skew"
    (tmp_path / name).write_text(json.dumps(payload))
    bad = violations(check_records(load_dir(str(tmp_path))))
    assert claim in {r.claim for r in bad}
    assert {r.claim for r in bad} == {r.claim for r in j_check_records(
        j_load_dir(str(tmp_path))) if not r.passed}


def test_reference_files_load_with_pred_us(tmp_path):
    rs = load_file(str(RUNS / "BENCH_spmv.json"))
    raw = json.loads((RUNS / "BENCH_spmv.json").read_text())["records"]
    assert [r.pred_us for r in rs.records] == [x["pred_us_v5e"] for x in raw]
    assert all(r.us_per_call is None and r.bound_bytes is None
               for r in rs.records)
    assert [r.timed_us for r in rs.records] == \
        [x["ref_us_per_call"] for x in raw]


def test_load_dir_skips_strays_with_a_warning(tmp_path):
    _dir_with(tmp_path, "axpy")
    shutil.copy(RUNS / "TRACE_chaos_scale_mesh2.json", tmp_path)
    (tmp_path / "notes.txt").write_text("x")
    with LOG.capture() as logs:
        sets = load_dir(str(tmp_path))
    assert [s.kernel for s in sets] == ["axpy"]
    assert [(r.msg, r.fields["file"]) for r in logs] == \
        [("skipping non-record file in record directory", "notes.txt")]


@pytest.mark.parametrize("payload,match", [
    ({"schema": 9, "records": []}, "unsupported schema"),
    ({"schema": 7, "kernel": "x"}, "records"),
    ({"schema": 7, "records": [{"kernel": "x"}]}, "missing fields"),
    ({"schema": 7, "records": []}, "no records"),
    ({"schema": 7, "kind": "stream", "records": []}, "unknown kind"),
])
def test_malformed_files_raise(tmp_path, payload, match):
    path = tmp_path / "BENCH_x.json"
    path.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match=match):
        load_file(str(path))


def test_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_dir(str(tmp_path))
