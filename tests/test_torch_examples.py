"""The port's examples (``examples_torch/``) on the CPU at small sizes.

Each runs through its ``main(argv)`` with ``--device cpu`` (the kernels'
plain versions): quickstart's and kernel_showdown's errors against their
oracles within the float32 claim (1e-4), serve_lm serving every request
it offers, and train_lm's crash-and-resume drill bit for bit against an
uninterrupted run.
"""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro_torch.optim.tree import leaves  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples_torch"
F32_TOL = 1e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "kernel_showdown"])
def test_kernel_examples_agree_with_their_oracles(name, capsys):
    errs = _load(name).main(["--device", "cpu"])
    assert errs and all(v <= F32_TOL for v in errs.values()), errs
    out = capsys.readouterr().out
    assert "vector" in out and "max" in out


def test_kernel_showdown_runs_every_engine_of_every_family():
    errs = _load("kernel_showdown").main(["--device", "cpu"])
    for name in ("scale", "spmv", "2d5pt", "3d27pt", "triad", "axpy"):
        assert {f"{name}/vector", f"{name}/matrix"} <= set(errs), name


@pytest.mark.parametrize("engine", ["vector", "matrix"])
def test_serve_lm_serves_every_request(engine, capsys):
    summary = _load("serve_lm").main(
        ["--device", "cpu", "--duration", "0.25", "--gen", "4",
         "--prompt-len", "8", "--engine", engine])
    assert summary.offered > 0 and summary.completed == summary.offered
    assert "[advisor]" in capsys.readouterr().out


def test_train_lm_resumes_bit_for_bit(tmp_path):
    train = _load("train_lm")
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
            "16", "--ckpt-every", "1"]
    straight = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    crash = argv + ["--ckpt-dir", str(tmp_path / "b"), "--fail-at", "2"]
    with pytest.raises(RuntimeError, match="injected failure"):
        train.main(crash)
    resumed = train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert float(resumed[2]["loss"]) == float(straight[2]["loss"])
    for a, b in zip(leaves(straight[0]), leaves(resumed[0])):
        assert torch.equal(a, b)
    for a, b in zip(leaves(straight[1].m), leaves(resumed[1].m)):
        assert torch.equal(a, b)
