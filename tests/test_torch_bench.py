"""The port's sweep (``repro_torch.bench``) against the reference's
``benchmarks``.

* ``records_for`` at ``test_size`` on the CPU (plain versions), with the
  reference's hardware model, gives the reference's analytic fields
  exactly and an error within the claims' tolerance.
* With the H100 model its records pass every claim of the port, and a
  written file loads back unchanged.
* The Table 1 / Eq. 14/23/24 rows and the Fig. 2 roofline rows equal the
  reference's for every platform both packages have.
* The CLI refuses what is not ported, naming the ROADMAP item, and
  ``tune --device cpu`` before timing anything; ``--tuned FILE`` sweeps
  launch with the cached tiles and record them in ``tile_config``.
* On the card (``gpu``): a sweep at ``test_size`` writes records that pass
  every claim, and the tracer does not move the recorded median.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from benchmarks import bench_bounds as j_bounds  # noqa: E402
from benchmarks import bench_kernels as j_kernels  # noqa: E402
from benchmarks import bench_roofline as j_roofline  # noqa: E402
from repro.core import PLATFORMS as J_PLATFORMS  # noqa: E402
from repro.kernels import registry as j_registry  # noqa: E402

from repro_torch.bench import bench_bounds, bench_kernels, bench_roofline  # noqa: E402
from repro_torch.bench import run as bench_run  # noqa: E402
from repro_torch.bench.common import SCHEMA_VERSION, bench_env, write_json  # noqa: E402
from repro_torch.core.hw import H100_SXM, TPU_V5E  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.report import (TOLERANCE, check_records, load_dir,  # noqa: E402
                                load_file, violations)

NAMES = ("attention", "axpy", "scale", "spmv", "stencil", "triad")
ANALYTIC = ("kernel", "engine", "size", "dtype", "intensity",
            "memory_bound", "engine_auto", "mxu_ceiling")


@pytest.fixture(scope="module")
def port_records():
    """The port's CPU records at test_size, per family, on the v5e model
    (the reference's) and on the H100 model."""
    out = {}
    for name in NAMES:
        op = registry.get(name)
        out[name] = {
            hw.name: bench_kernels.records_for(op, (op.test_size,), hw=hw,
                                               device="cpu")
            for hw in (TPU_V5E, H100_SXM)}
    return out


@pytest.mark.parametrize("name", NAMES)
def test_records_match_reference(name, port_records):
    jop = j_registry.get(name)
    want = j_kernels.records_for(
        dataclasses.replace(jop, bench_sizes=(jop.test_size,)))
    got = port_records[name][TPU_V5E.name]
    assert len(got) == len(want) == 2 * len(jop.dtypes)
    for g, w in zip(got, want):
        assert {k: g[k] for k in ANALYTIC} == {k: w[k] for k in ANALYTIC}
        for key in ("traffic_bytes", "work_flops"):
            assert g["trace"]["roofline"][key] == \
                w["trace"]["roofline"][key]
        assert g["pred_us"] == w["pred_us_v5e"]
        tol = TOLERANCE[g["dtype"]]
        assert g["max_err"] <= tol and w["max_err"] <= tol
        assert g["mesh_shape"] is g["shard_spec"] is g["mesh_exec"] is None
        assert g["tile_config"] is None
        assert g["trace"]["clock"] == "wall"
        assert g["trace"]["spans"] == g["iters"]
        assert g["profiler_device_us"] is None


@pytest.mark.parametrize("name", NAMES)
def test_h100_records_pass_every_claim(name, port_records, tmp_path):
    recs = port_records[name][H100_SXM.name]
    write_json(name, recs, str(tmp_path), env=bench_env("cpu", "H100-SXM5"))
    results = check_records(load_dir(str(tmp_path)))
    assert len(results) == 5 * len(recs)
    assert not violations(results), [r.detail for r in violations(results)]
    assert all(r["l2_resident"] for r in recs)
    assert all(r["engine_auto"] == "vector" for r in recs)


def test_written_file_loads_back_unchanged(port_records, tmp_path):
    recs = port_records["attention"][H100_SXM.name]
    env = bench_env("cpu", H100_SXM.name)
    path = write_json("attention", recs, str(tmp_path), env=env)
    payload = json.loads(open(path).read())
    assert payload == {"schema": SCHEMA_VERSION, "kernel": "attention",
                       "env": env, "records": recs}
    rs = load_file(path)
    assert rs.schema == 7 and rs.kind == "bench" and dict(rs.env) == env
    for rec, raw in zip(rs.records, recs):
        for key in ("kernel", "engine", "size", "dtype", "ref_us_per_call",
                    "us_per_call", "iqr_us", "iters", "max_err",
                    "intensity", "memory_bound", "engine_auto",
                    "mxu_ceiling", "pred_us", "bound_bytes", "l2_resident",
                    "profiler_device_us", "trace"):
            assert getattr(rec, key) == raw[key], key
        assert rec.timed_us == raw["us_per_call"]


def test_attention_bound_counts_the_valid_positions():
    op = registry.get("attention")
    args, kw = op.make_inputs(np.random.default_rng(0), 1024, device="cpu")
    q, k, v, kv_len = args
    traits = op.traits(*args, **kw)
    traffic, work = bench_kernels.bound_work("attention", args, traits)
    assert kv_len == 1024 - 128
    assert traffic == (2 * k.numel() * kv_len // 1024 + 2 * q.numel()) * 4
    assert traffic < traits.traffic_bytes
    assert work == traits.work_flops * kv_len / 1024
    assert bench_kernels.bound_work("attention", (q, k, v, 0), traits)[0] \
        == (2 * k.numel() + 2 * q.numel()) * 4
    scale = registry.get("scale")
    sargs, skw = scale.make_inputs(np.random.default_rng(0), 64,
                                   device="cpu")
    straits = scale.traits(*sargs, **skw)
    assert bench_kernels.bound_work("scale", sargs, straits) == \
        (straits.traffic_bytes, straits.work_flops)


STREAM = {
    "scale": [(2**26, "float32"), (2**27, "bfloat16")],
    "triad": [(2**26, "float32"), (2**27, "bfloat16")],
    "axpy": [(2**26, "float32"), (2**27, "bfloat16")],
    "spmv": [(8192, "float32")],
    "stencil": [(8192, "float32"), ((512, 512, 512), "float32")],
    "attention": [((4, 8, 4, 128), "float32"), ((4, 32768, 8, 128),
                                                "float32"),
                  ((4, 32768, 8, 128), "float32"), ((4, 8, 4, 128),
                                                    "bfloat16"),
                  ((4, 32768, 8, 128), "bfloat16"),
                  ((4, 32768, 8, 128), "bfloat16")],
}


@pytest.mark.parametrize("name", NAMES)
def test_stream_points_of_every_family(name, monkeypatch):
    """The STREAM inputs each family asks for, recorded instead of drawn
    (the real ones take gigabytes): every array at least 4x the L2."""
    asked = []

    def fake_inputs(rng, size, dtype="float32", device="cuda"):
        asked.append((size, dtype))
        return ("input",), {}

    def fake_normal(rng, shape, dtype, device):
        asked.append((shape, dtype))
        return torch.empty(0)
    monkeypatch.setattr(bench_kernels, "_normal", fake_normal)
    op = dataclasses.replace(registry.get(name), make_inputs=fake_inputs)
    points = list(bench_kernels.stream_points(op, np.random.default_rng(0),
                                              "cpu"))
    assert asked == STREAM[name]
    assert len(points) == (2 if name != "spmv" else 1)
    if name in ("scale", "triad", "axpy"):
        for pt in points:
            nbytes = pt.size * (4 if pt.dtype == "float32" else 2)
            assert nbytes >= 4 * H100_SXM.l2_bytes
    if name == "attention":
        assert [pt.args[3] for pt in points] == [28672, 28672]
    with pytest.raises(KeyError):
        next(bench_kernels.stream_points(
            dataclasses.replace(op, name="gemv"), None, "cpu"))


def test_bounds_and_roofline_rows_match_reference():
    def shared(rows):
        return [r for r in rows if r["name"].split("/")[1] in J_PLATFORMS]
    assert shared(bench_bounds.rows()) == j_bounds.rows()
    assert shared(bench_roofline.rows()) == j_roofline.rows()
    names = {r["name"].split("/")[1] for r in bench_bounds.rows()}
    assert {"h100", "h100pcie", "h100nvl"} <= names


def test_tracer_overhead_reports_both_sides():
    op = registry.get("scale")
    args, kw = op.make_inputs(np.random.default_rng(0), 4096, device="cpu")
    out = bench_kernels.tracer_overhead(op, args, kw, "vector", device="cpu")
    assert set(out) == {"untraced_us", "untraced_iqr_us", "traced_us",
                        "traced_iqr_us", "agree"}
    assert out["traced_us"] > 0 and out["untraced_us"] > 0


@pytest.mark.parametrize("argv,item", [
    (["serve", "--slo-route"], "item 13"),
    (["serve", "--chaos", "fail@0.1:1"], "items 13-14"),
    (["report", "--mesh", "2"], "item 13"), (["scale", "--mesh", "2"],
                                             "item 13"),
    (["scale", "--real"], "item 13"), (["tune", "--device", "cpu"],
                                       "refused at persist"),
])
def test_cli_refuses_what_is_not_ported(argv, item):
    with pytest.raises(SystemExit, match=item):
        bench_run.main(argv)


def test_tune_refuses_the_cpu_before_timing(monkeypatch, tmp_path):
    from repro_torch.bench import tune
    monkeypatch.setattr(tune, "tune_op", None)  # never reached
    out = tmp_path / "tuned.json"
    with pytest.raises(SystemExit) as stop:
        bench_run.main(["tune", "--device", "cpu", "--out", str(out)])
    assert stop.value.code != 0 and "plain versions" in str(stop.value.code)
    assert not out.exists()


def test_tune_default_out_is_under_build():
    from repro_torch.bench import tune
    assert tune.DEFAULT_OUT == os.path.join("build", "runs_torch",
                                            "tuned.json")


def test_cli_tuned_sweep_records_its_tiles(tmp_path, capsys):
    from repro_torch.core.dispatch import DEFAULT_DISPATCHER
    from repro_torch.tuning import TunedEntry, TuningCache
    hw = DEFAULT_DISPATCHER.hw.name
    path = str(tmp_path / "tuned.json")
    TuningCache([
        TunedEntry("stencil", "vector", "float32", hw, {"block_rows": 32},
                   290.0, 300.0, 8192),
        TunedEntry("attention", "matrix", "bfloat16", hw, {"block_s": 128},
                   150.0, 151.0, 32768),
    ]).save(path)
    out = tmp_path / "runs"
    bench_run.main(["stencil", "attention", "--device", "cpu", "--out",
                    str(out), "--tuned", path])
    csv = capsys.readouterr().out
    assert "tiles=block_rows=32" in csv and "tiles=block_s=128" in csv
    recs = {rs.kernel: rs.records for rs in load_dir(str(out))}
    for rec in recs["stencil"]:
        want = ({"params": {"block_rows": 32}, "tuned_us": 290.0,
                 "default_us": 300.0, "source": "cuda"}
                if rec.engine == "vector" else None)
        assert rec.tile_config == want
    tiled = [r for r in recs["attention"] if r.tile_config]
    assert {(r.engine, r.dtype) for r in tiled} == {("matrix", "bfloat16")}
    assert tiled[0].tuned_speedup == pytest.approx(151.0 / 150.0)
    assert not violations(check_records(load_dir(str(out))))


@pytest.mark.parametrize("argv,match", [
    (["nope"], "unknown benchmark"),
    (["bounds", "--stream"], "only applies"),
    (["scale", "--device", "tpu"], "--device"),
    (["scale", "--stream", "--device", "cpu"], "needs --device cuda"),
])
def test_cli_rejects_bad_arguments(argv, match):
    with pytest.raises(SystemExit, match=match):
        bench_run.main(argv)


def test_cli_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(SystemExit, match="no card"):
        bench_run.main(["scale"])


def test_cli_sweeps_on_the_cpu(tmp_path, capsys):
    trace = tmp_path / "t.json"
    bench_run.main(["triad", "--device", "cpu", "--out", str(tmp_path),
                    "--trace", str(trace)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert len(out) == 1 + 2 * 3 * 2  # engines x bench_sizes x dtypes
    assert all("bound_share=not measured" in line for line in out[1:])
    (rs,) = load_dir(str(tmp_path))
    assert rs.env["device"] == "cpu" and rs.env["hw_model"] == "H100-SXM5"
    assert not violations(check_records([rs]))
    from repro_torch.obs.trace import read_chrome_trace
    names = {e["name"] for e in read_chrome_trace(str(trace))["traceEvents"]}
    assert {"dispatch", "launch", "engine_call", "ref_call"} <= names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
def test_card_sweep_passes_every_claim(card, tmp_path):
    from repro_torch.core.hw import spec_for_device_name
    hw = spec_for_device_name(card)
    for op in registry.all_ops():
        recs = bench_kernels.records_for(op, (op.test_size,), hw=hw)
        write_json(op.name, recs, str(tmp_path), env=bench_env("cuda",
                                                               hw.name))
    sets = load_dir(str(tmp_path))
    assert {s.env["device"] for s in sets} == {"gpu"}
    results = check_records(sets)
    assert len(results) == 5 * sum(len(s.records) for s in sets)
    assert not violations(results), [r.detail for r in violations(results)]
    for s in sets:
        for rec in s.records:
            assert rec.trace["clock"] == "cuda_event"
            assert rec.profiler_device_us > 0


@pytest.mark.gpu
def test_card_tracer_leaves_the_median_alone(card):
    op = registry.get("scale")
    pt = next(bench_kernels.stream_points(op, np.random.default_rng(0),
                                          "cuda"))
    out = bench_kernels.tracer_overhead(op, pt.args, pt.kwargs, "vector")
    assert out["agree"], out
