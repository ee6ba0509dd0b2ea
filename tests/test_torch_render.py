"""The port's report renderer against the reference's ``repro.report.render``,
and the tuning / serving / report slice end to end on the CPU.

* Every committed non-mesh record set under ``runs/`` renders to the
  committed ``docs/benchmarks/`` page byte for byte, and ``render_report``
  over those sets equals the reference's.  A mesh set raises naming
  ROADMAP item 13.
* ``write_report`` never defaults to the repository's own ``REPORT.md`` or
  ``docs/benchmarks/`` (it deletes orphan pages in its docs directory).
* The slice: ``kernels --device cpu`` into one directory, an online-tuned
  serving session on the plain backend beside it, ``report`` on that
  directory: zero violations, the ceiling column at 0, two renders
  byte-identical, in the port's voice.
"""
import inspect
import os
import pathlib
import re
import shutil

import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro.report import load_dir as j_load_dir  # noqa: E402
from repro.report import render_report as j_render_report  # noqa: E402

from repro_torch.bench import compare as p_compare  # noqa: E402
from repro_torch.bench import run as bench_run  # noqa: E402
from repro_torch.report import (check_records, load_dir,  # noqa: E402
                                load_file, render_kernel_page,
                                render_report, render_serving_page,
                                violations, write_report)
from repro_torch.report.render import page_name  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
RUNS = REPO / "runs"
DOCS = REPO / "docs" / "benchmarks"
NON_MESH = ("BENCH_attention.json", "BENCH_axpy.json", "BENCH_scale.json",
            "BENCH_spmv.json", "BENCH_stencil.json", "BENCH_triad.json",
            "BENCH_serve_axpy.json", "BENCH_serve_axpy_online.json",
            "BENCH_serve_lm-deepseek-7b.json",
            "BENCH_serve_lm-mamba2-780m.json",
            "BENCH_serve_lm-qwen3-moe-235b-a22b.json",
            "BENCH_serve_scale.json", "BENCH_serve_scale_online.json",
            "BENCH_serve_triad.json")
MESH = ("BENCH_scale_mesh2.json", "BENCH_scale_mesh4.json",
        "BENCH_stencil_mesh2.json", "BENCH_serve_scale_mesh2.json")


def _render(rs):
    return (render_serving_page if rs.kind == "serving"
            else render_kernel_page)(rs)


def test_every_committed_set_is_listed():
    names = {p.name for p in RUNS.glob("BENCH_*.json")}
    assert names == set(NON_MESH) | set(MESH)


@pytest.mark.parametrize("name", NON_MESH)
def test_page_matches_the_committed_page(name):
    rs = load_file(str(RUNS / name))
    assert _render(rs) == (DOCS / page_name(rs)).read_text()


def test_report_matches_reference_over_the_non_mesh_sets(tmp_path):
    for name in NON_MESH:
        shutil.copy(RUNS / name, tmp_path)
    got = render_report(load_dir(str(tmp_path)))
    assert got == j_render_report(j_load_dir(str(tmp_path)))
    assert "## Online tuning" in got


@pytest.mark.parametrize("name", MESH)
def test_mesh_sets_raise(tmp_path, name):
    rs = load_file(str(RUNS / name))
    for render in (render_report, lambda rs: _render(rs[0])):
        with pytest.raises(NotImplementedError, match="item 13"):
            render([rs])
    shutil.copy(RUNS / name, tmp_path)
    with pytest.raises(NotImplementedError, match="item 13"):
        write_report(str(tmp_path), str(tmp_path / "R.md"),
                     str(tmp_path / "docs"))
    assert not (tmp_path / "R.md").exists()


def test_write_report_defaults_stay_under_build():
    defaults = {k: v.default for k, v in
                inspect.signature(write_report).parameters.items()}
    for key in ("runs_dir", "report_path", "docs_dir"):
        assert pathlib.PurePath(defaults[key]).parts[0] == "build", key
    assert os.path.normpath(defaults["report_path"]) != "REPORT.md"
    assert os.path.normpath(defaults["docs_dir"]) != \
        os.path.join("docs", "benchmarks")


def test_write_report_drops_orphans_and_is_deterministic(tmp_path):
    runs = tmp_path / "runs"
    runs.mkdir()
    for name in ("BENCH_scale.json", "BENCH_serve_scale_online.json"):
        shutil.copy(RUNS / name, runs)
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "gone.md").write_text("orphan")
    (docs / "keep.txt").write_text("not a page")
    first = write_report(str(runs), str(tmp_path / "R.md"), str(docs))
    texts = [pathlib.Path(p).read_text() for p in first]
    assert sorted(os.listdir(docs)) == ["keep.txt", "scale-serving-online.md",
                                        "scale.md"]
    second = write_report(str(runs), str(tmp_path / "R.md"), str(docs))
    assert first == second
    assert [pathlib.Path(p).read_text() for p in second] == texts


def _ceiling_column(report: str):
    """The Eq. 23/24 ceiling column of REPORT.md's claim table."""
    rows = report.split("## Claim verification")[1].split("\n\n")[2]
    return [line.split(" | ")[2] for line in rows.splitlines()[2:]]


def test_the_slice_on_the_cpu(tmp_path, capsys):
    runs = tmp_path / "runs"
    bench_run.main(["kernels", "--device", "cpu", "--out", str(runs)])
    with pytest.raises(SystemExit) as stop:
        bench_run.main(["serve", "--device", "cpu", "--size", "4096",
                        "--duration", "0.2", "--online-tune",
                        "--tune-budget", "4", "--out", str(runs)])
    assert stop.value.code == 0
    capsys.readouterr()
    sets = load_dir(str(runs))
    online = [rs for rs in sets if page_name(rs).endswith("-online.md")]
    assert sorted(rs.kernel for rs in online) == ["axpy", "scale", "triad"]
    results = check_records(sets)
    assert results and not violations(results)
    assert {r.claim for r in results} >= {"online_ceiling", "ceiling"}
    assert (runs / "tuned-online.json").is_file()
    assert p_compare.compare(str(runs), str(runs)) == []

    bench_run.main(["report", str(runs)])
    written = capsys.readouterr().out.splitlines()
    report = (runs / "REPORT.md").read_text()
    assert written[0] == f"wrote {runs / 'REPORT.md'}"
    assert len(written) == 1 + len(sets)
    assert _ceiling_column(report) == ["0 ✅"] * 6
    assert "zero claim violations" in report
    assert "Generated by `python -m repro_torch.bench report`" in report
    assert "online-tuned sessions; zero claim violations" in report
    pages = {p.name: p.read_text()
             for p in (runs / "docs" / "benchmarks").iterdir()}
    bench_run.main(["report", "--out", str(runs)])
    assert (runs / "REPORT.md").read_text() == report
    assert pages == {p.name: p.read_text()
                     for p in (runs / "docs" / "benchmarks").iterdir()}
    # the port's kernel pages show the engine kernel's own median
    rs = load_file(str(runs / "BENCH_scale.json"))
    page = pages["scale.md"]
    assert "| µs (median) |" in page and "pred µs |" in page
    first = page.split("|---|")[-1].splitlines()[1]
    assert re.split(r" \| ", first)[3] == f"{rs.records[0].us_per_call:.6g}"
