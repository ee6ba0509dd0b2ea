"""What the port still refuses names ROADMAP Queue 1 item 14, and nothing
that is ported refuses.

* No module that held a refusal table (the claims', the compare gate's,
  ``serve``'s, the sweep CLI's, the batcher's, the renderer's, the
  dispatcher's) holds one now, and none names a ROADMAP item but 14.
* No source file of the port cites item 13: the measured mesh (13.3)
  was its last part.
* ``serve --mesh 4``, ``serve --online-tune --slo-route`` (router widths
  above 1 under an overload), ``serve --chaos SPEC`` and ``serve --mesh 2
  --real`` run on the CPU and write records that pass every claim and the
  compare gate; ``kernels --mesh 2 --real`` writes schema-6 records with
  ``mesh_exec`` that pass the mesh claims.
"""
import json
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.bench import compare, run as bench_run, serve  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.report import (check_records, claims, load_dir,  # noqa: E402
                                render, violations)
from repro_torch.serving import batcher  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

#: A ROADMAP Queue 1 item citation: "item 13.3", "items 13-14", ...
CITATION = re.compile(r"items? (\d+(?:\.\d+)?(?:-\d+(?:\.\d+)?)?)")

#: The names the refusal tables had.
TABLES = ("WAITING", "_WAITING", "WAITING_FLAGS", "MESH_WAITS",
          "MEASURED_MESH_WAITS")


def _cited(text: str):
    return CITATION.findall(text)


@pytest.mark.parametrize("module", [
    claims, compare, serve, bench_run, batcher, render, dispatch,
], ids=["claims", "compare", "serve", "run", "batcher", "render",
        "dispatch"])
def test_refusal_tables_name_only_13_3_or_14(module):
    assert not [t for t in TABLES if hasattr(module, t)], module.__name__
    text = pathlib.Path(module.__file__).read_text()
    assert all(i.split(".")[0] == "14" for i in _cited(text)), \
        (module.__name__, _cited(text))
    assert "NotImplementedError" not in text, module.__name__


def test_no_source_cites_item_13_for_what_is_ported():
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for item in _cited(text):
            if item.startswith("13"):
                bad.append(f"{path.relative_to(REPO)}: item {item}")
    assert not bad, bad


def _records_pass(out):
    sets = load_dir(str(out))
    results = check_records(sets)
    assert results and not violations(results)
    assert compare.compare(str(out), str(out)) == []
    return sets


def test_serve_mesh_runs_on_the_cpu(tmp_path):
    assert serve.main(["--device", "cpu", "--size", "4096", "--duration",
                       "0.2", "--kernels", "scale,spmv", "--mesh", "4",
                       "--out", str(tmp_path)]) == 0
    sets = _records_pass(tmp_path)
    assert sorted(p.name for p in tmp_path.glob("*.json")) == [
        "BENCH_serve_scale_mesh4.json", "BENCH_serve_spmv_mesh4.json"]
    for rs in sets:
        assert rs.env["mesh_shape"] == [4]
        assert all(r.num_shards == 4 and r.mesh_exec_mode == "virtual"
                   for r in rs.records)


def test_serve_slo_route_grows_widths_on_the_cpu(tmp_path):
    """An overload (100k req/s of 4096 elements) deepens the queue past
    the router's grow depth with thin headroom: widths above 1."""
    assert serve.main(["--device", "cpu", "--size", "4096", "--duration",
                       "0.05", "--rate", "100000", "--kernels", "scale",
                       "--online-tune", "--slo-route",
                       "--out", str(tmp_path)]) == 0
    _records_pass(tmp_path)
    rec = json.loads((tmp_path / "BENCH_serve_scale_online.json")
                     .read_text())["records"][0]
    widths = {d["width"] for d in rec["tuning"]["router"]["decisions"]}
    assert max(widths) > 1, widths
    from repro_torch.core.dispatch import DEFAULT_DISPATCHER
    assert DEFAULT_DISPATCHER.mesh_shards == 1  # restored after


def test_serve_chaos_runs_on_the_cpu(tmp_path):
    assert serve.main(["--device", "cpu", "--size", "4096", "--duration",
                       "0.3", "--rate", "128", "--kernels", "scale",
                       "--mesh", "2", "--chaos", "fail@0.05:1,resize@0.1:4",
                       "--out", str(tmp_path)]) == 0
    (rs,) = _records_pass(tmp_path)
    assert rs.path.endswith("BENCH_serve_scale_mesh2.json")
    for rec in rs.records:
        assert rec.events["spec"] == "fail@0.05:1,resize@0.1:4"
        assert rec.events["checksum"] == rec.events["fault_free"]["checksum"]
    assert "elastic_integrity" in {r.claim for r in check_records([rs])}


@pytest.fixture
def two_ranks():
    from repro_torch.launch import mesh
    from repro_torch.sharding import ranks
    before = mesh.host_ranks()
    mesh.host_device_count(2)
    yield
    ranks.close_pool()
    mesh.host_device_count(before)


def test_serve_real_runs_on_the_cpu(tmp_path, two_ranks):
    assert serve.main(["--device", "cpu", "--size", "4096", "--duration",
                       "0.1", "--rate", "200", "--kernels", "scale",
                       "--mesh", "2", "--real", "--out", str(tmp_path)]) == 0
    (rs,) = _records_pass(tmp_path)
    assert rs.env["mesh_exec_mode"] == "mesh"
    assert all(r.num_shards == 2 and r.mesh_exec_mode == "mesh"
               and r.completed > 0 for r in rs.records)


def test_kernels_real_runs_on_the_cpu(tmp_path, two_ranks):
    bench_run.main(["scale", "--device", "cpu", "--mesh", "2", "--real",
                    "--out", str(tmp_path)])
    (rs,) = _records_pass(tmp_path)
    probe = rs.env["collective_overlap"]
    assert probe["devices"] == 2 and probe["ring_us"] > 0
    assert all(r.mesh_exec["devices"] == 2 and r.mesh_exec["skew"] > 0
               for r in rs.records)
    assert {"collective_cost", "mesh_skew"} <= {
        r.claim for r in check_records([rs])}
