"""On the card: each cell runs through ``run.py`` with a short window,
untraced and traced, and comes out correct with its metrics.  Run with
``pytest -m gpu perfbench/tests`` on a machine with an H100; elsewhere
these skip."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench.harness import core

BENCH = core.benchmark()


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 101), "--seconds", "6", "--trace", str(trace)],
        cwd=core.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    want = {m["name"] for m in core.selected_metrics(BENCH, cell, bool(trace))}
    assert want == set(result["metrics"])
    assert result["device"]["platform"] == "gpu"
