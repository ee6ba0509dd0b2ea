"""Small configurations of the committed cells, for runs on the CPU.

Each keeps its committed workload's driver, engine and limits and cuts
only the sizes, so a test drives the whole run (set-up, window, check,
metrics) with the port's plain versions in a second or two.
"""
from __future__ import annotations

import copy
import sys
import time

from perfbench.harness import core

sys.path.insert(0, str(core.ROOT / "src"))

STREAM_SUITE = [
    {"family": "scale", "n": 4096},
    {"family": "triad", "n": 4096},
    {"family": "spmv", "rows": 64, "cols": 256, "density": 0.05,
     "block": [8, 128]},
    {"family": "stencil", "name": "2d5pt", "shape": [40, 48], "steps": 3,
     "center": 0.4, "wing": [0.15]},
    {"family": "stencil", "name": "3d7pt", "shape": [12, 14, 16],
     "steps": 3, "center": 0.4, "wing": [0.1]},
    {"family": "attention", "b": 1, "kh": 2, "g": 4, "dh": 64, "s": 256,
     "kv_len": 200},
]

DENSE = {"hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "num_hidden_layers": 2, "vocab_size": 512}

DECODE = {"batch": 2, "history": 48, "cache_len": 112, "warmup_steps": 2,
          "logit_stride": 4, "check_block": 8, "events": 0,
          "trace_after_s": 0.05, "trace_units": 3,
          "trace_lead": 1}


def cell(name: str):
    """(configuration, workload) of committed cell ``name``, cut small."""
    bench = core.benchmark()
    entry = core.cell_entry(bench, name)
    cfg = copy.deepcopy(core.config(entry["config"]))
    wl = copy.deepcopy(core.workload(name))
    if wl["driver"] == "stream_suite":
        cfg["suite"] = copy.deepcopy(STREAM_SUITE)
        wl.update(check_pass_window=4, trace_after_s=0.05, trace_units=3,
                  trace_lead=1)
    else:
        cfg.update(DENSE)
        wl.update(DECODE)
    return bench, cfg, wl


def run(name: str, *, seed: int = 7, seconds: float = 0.3,
        trace: bool = False, control: bool = False, drv=None, logs=None,
        **workload):
    """One run of ``name`` at the small sizes on the CPU (``workload``
    overrides its traffic's parameters)."""
    import torch
    from perfbench.harness.runner import run_files
    bench, cfg, wl = cell(name)
    wl.update(workload)
    log = logs.append if logs is not None else (lambda m: None)
    return run_files(torch, bench=bench, cell=name, cfg=cfg, wl=wl,
                     seed=seed, seconds=seconds, trace=trace, device="cpu",
                     t_start=time.perf_counter(), log=log, control=control,
                     drv=drv)
