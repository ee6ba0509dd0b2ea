"""What the port still refuses names ROADMAP Queue 1 item 13.3 or 14, and
nothing that is ported refuses.

* Every refusal table (``_WAITING`` of the claims, ``WAITING`` of the
  compare gate and of ``serve``, ``WAITING_FLAGS`` of the sweep CLI, the
  batcher's and the renderer's ``MESH_WAITS``, the dispatcher's
  ``MEASURED_MESH_WAITS``) names item 13.3 or an item of 14 and no other.
* No source file of the port cites item 13 (or items 13-14) for what this
  slice ported: every citation of item 13 is of 13.3.
* ``serve --mesh 4``, ``serve --online-tune --slo-route`` (router widths
  above 1 under an overload) and ``serve --chaos SPEC`` run on the CPU and
  write records that pass every claim and the compare gate.
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


def _cited(text: str):
    return CITATION.findall(text)


@pytest.mark.parametrize("table", [
    claims._WAITING, compare.WAITING, serve.WAITING, bench_run.WAITING_FLAGS,
    {"batcher": batcher.MESH_WAITS}, {"render": render.MESH_WAITS},
    {"dispatch": dispatch.MEASURED_MESH_WAITS},
], ids=["claims", "compare", "serve", "run", "batcher", "render",
        "dispatch"])
def test_refusal_tables_name_only_13_3_or_14(table):
    assert table
    for text in table.values():
        items = _cited(text)
        assert items, text
        assert all(i == "13.3" or i.split(".")[0] == "14" for i in items), \
            text


def test_no_source_cites_item_13_for_what_is_ported():
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for item in _cited(text):
            if item.startswith("13") and item != "13.3":
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
