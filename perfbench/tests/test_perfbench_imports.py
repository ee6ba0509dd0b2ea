"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level module names compared whole: ``repro_torch`` is the port),
and the command refuses, with no result, where it cannot run."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

from perfbench.harness import core

FILES = sorted(core.PB.rglob("*.py"))


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    bad = [(str(p.relative_to(core.ROOT)), name) for p in FILES
           for name in _top_level_imports(p) if name in core.FORBIDDEN]
    assert not bad
    assert "repro_torch" not in core.FORBIDDEN


def test_no_source_reads_the_jax_packages_benchmarks():
    for p in FILES:
        assert "benchmarks" not in set(_top_level_imports(p)), p
        if p.parent.name != "tests":
            assert "benchmarks/" not in p.read_text(), p


def test_a_whole_run_loads_no_forbidden_module():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(core.ROOT)!r}, {str(core.ROOT / 'src')!r}]\n"
        "import torch\n"
        "from perfbench.tests import tiny\n"
        "for cell in ('paper-stream-f32.vector',\n"
        "             'mistral-nemo-12b-pp4.decode32k.vector'):\n"
        "    assert tiny.run(cell, seconds=0.2)['correct']\n"
        "from perfbench.harness import core\n"
        "print(core.forbidden_modules())\n"
        "sys.exit(1 if core.forbidden_modules() else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert "repro_torchlike" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.sub", sys)
    assert "repro.sub" in core.forbidden_modules()


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "paper-stream-f32.vector", "--seed", str(2**31 + 5), "--seconds",
         "1", *args], cwd=cwd, capture_output=True, text=True, env=env,
        timeout=300)


def test_without_a_card_the_run_exits_non_zero_with_no_result():
    proc = _run(core.ROOT, "--trace", "0")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_with_only_the_benchmark_files_the_run_exits_non_zero(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, "--trace", "1")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert not pathlib.Path(tmp_path / "src").exists()
