"""One run of one cell, as ``run.py`` makes it and the tests drive it."""
from __future__ import annotations

import json
import sys
from typing import Callable, Optional

from . import core, tracing


def run_cell(torch, *, bench: dict, cell: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             log: Optional[Callable[[str], None]] = None,
             control: bool = False) -> dict:
    """Set-up, window, check and metrics of one run of ``cell``; returns
    the result object (the contract's keys, ``checks`` last)."""
    entry = core.cell_entry(bench, cell)
    wl = core.workload(cell)
    cfg = core.config(entry["config"])
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{cell}.json names {wl['config']!r} / "
                         f"{wl['traffic']!r}, BENCHMARK.json "
                         f"{entry['config']!r} / {entry['traffic']!r}")
    return run_files(torch, bench=bench, cell=cell, cfg=cfg, wl=wl,
                     seed=seed, seconds=seconds, trace=trace, device=device,
                     t_start=t_start, log=log, control=control)


def run_files(torch, *, bench: dict, cell: str, cfg: dict, wl: dict,
              seed: int, seconds: float, trace: bool, device: str,
              t_start: float, log: Optional[Callable[[str], None]] = None,
              control: bool = False, drv=None) -> dict:
    """``run_cell`` with the configuration and workload given as dicts
    (the tests' small sizes) and optionally another driver module."""
    log = log or (lambda msg: print(f"[perfbench] {msg}", file=sys.stderr,
                                    flush=True))
    cuda = device.startswith("cuda")
    out_dir = core.OUT / cell
    tracer = tracing.SubWindow(
        torch, enabled=trace, after_s=min(wl["trace_after_s"], 0.3 * seconds),
        units=wl["trace_units"], lead=wl["trace_lead"], device=device,
        out_dir=out_dir,
        stem=f"seed{seed}.trace")
    ctx = core.Context(torch, cell, cfg, wl, seed, seconds, device, tracer,
                       log)
    drv = drv or core.driver(wl["driver"])
    setup_s, record, numbers = core.execute(ctx, drv, t_start,
                                            control=control)
    smi = record.pop("smi")
    judged = core.judge(numbers, wl["limits"])
    bad = core.failing(judged)
    name = torch.cuda.get_device_name() if cuda else "cpu"
    run = core.RunData(cell, cfg, wl, setup_s, record, tracer.trace,
                       core.peaks_for(name))
    metrics = {}
    for m in core.selected_metrics(bench, cell, trace):
        value = core.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(record["memory_peak_bytes"]),
           "power_limit_w": core.power_limit_w(smi)}
    result = {"correct": not bad, "attempted": int(record["attempted"]),
              "failed": len(bad), "metrics": metrics, "device": dev}
    tr = tracer.trace
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
        log(f"trace: {len(tr.ops)} device ops, {tr.unattributed} with no "
            f"benchmark range; ranges {sorted(set(r[0] for r in tr.ranges))}")
    result["checks"] = judged
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"seed{seed}.trace{int(trace)}.json", "w") as f:
        json.dump({"result": result, "setup_s": setup_s,
                   "window": {k: v for k, v in record.items()
                              if k not in ("itl_ms", "host_ms", "kv_lens")},
                   "smi": smi}, f, indent=1)
    return result
