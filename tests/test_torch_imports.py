"""Guards on the port's boundaries.

* The port imports neither JAX nor the reference package ``repro``,
  at run time (a fresh interpreter; the training and the sharding
  modules each on their own too) or in its source (an AST scan of
  ``src/repro_torch`` and ``chip_smoke.py``).
* Its entry points do not fall back: ``backend="cuda"`` on CPU tensors
  raises, and so does the default ``device="cuda"`` where there is no
  card.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro_torch.kernels import registry  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_fresh_interpreter_loads_no_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels import registry\n"
        "assert len(registry.all_ops()) == 6\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: The training slice's modules: optimizer, pipeline, checkpoints, the
#: loop and the launcher.
TRAINING = ("repro_torch.optim.adamw", "repro_torch.optim.compression",
            "repro_torch.optim.tree", "repro_torch.data.pipeline",
            "repro_torch.runtime.checkpoint", "repro_torch.runtime.train_loop",
            "repro_torch.launch.cells", "repro_torch.launch.steps",
            "repro_torch.launch.train")


#: The sharding slice's modules: the plan, the executors, the ranks, the
#: rules, the collective matmuls, the meshes, the elastic session and the
#: mesh transition it records.
SHARDING = ("repro_torch.sharding", "repro_torch.sharding.plan",
            "repro_torch.sharding.executor", "repro_torch.sharding.ranks",
            "repro_torch.sharding.rules",
            "repro_torch.sharding.collective_matmul",
            "repro_torch.launch.mesh", "repro_torch.serving.elastic",
            "repro_torch.runtime.elastic")


def test_sharding_modules_load_no_jax_or_reference():
    """The sharding and elastic modules, imported on their own in a fresh
    interpreter, pull in neither JAX nor the reference; each is among the
    sources the AST scan below reads."""
    names = {str(p.relative_to(REPO / "src"))[:-3].replace("/", ".")
             .removesuffix(".__init__") for p in _port_files()[:-1]}
    assert set(SHARDING) <= names
    code = ("import sys\n"
            f"for m in {SHARDING!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_modules_load_no_jax_or_reference():
    """The training modules, imported on their own in a fresh
    interpreter, pull in neither JAX nor the reference; each is among the
    sources the AST scan below reads."""
    names = {str(p.relative_to(REPO / "src"))[:-3].replace("/", ".")
             for p in _port_files()[:-1]}
    assert set(TRAINING) <= names
    code = ("import sys\n"
            f"for m in {TRAINING!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("engine", ["vector", "matrix", "auto"])
@pytest.mark.parametrize("name", ["attention", "axpy", "scale", "spmv", "stencil",
                                  "triad"])
def test_cuda_backend_on_cpu_tensors_raises(name, engine):
    op = registry.get(name)
    args, kw = op.make_inputs(np.random.default_rng(0), op.test_size,
                              device="cpu")
    with pytest.raises(ValueError, match="card"):
        op(*args, engine=engine, **kw)  # backend defaults to "cuda"


@pytest.mark.parametrize("name", ["attention", "axpy", "scale", "spmv", "stencil",
                                  "triad"])
def test_default_device_raises_without_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    op = registry.get(name)
    with pytest.raises((RuntimeError, AssertionError)):
        op.make_inputs(np.random.default_rng(0), 64)


def test_plain_backend_refuses_card_tensors():
    from repro_torch.core.dispatch import check_backend
    with pytest.raises(ValueError, match="backend"):
        check_backend("eager", torch.zeros(2))
    check_backend("plain", torch.zeros(2))
