"""One run of one cell: set-up, the timed window, the check against the
plain reference, the metrics and the result line.

Every cell is found by name.  ``BENCHMARK.json`` names its configuration
and traffic; ``workloads/<cell>.json`` holds the traffic's parameters,
the limits of its check and the name of its driver, a module of
``traffic/``; ``configs/<config>.json`` holds the configuration, and
``metrics/<metric>.py`` one reader per metric.  A cell, a configuration
or a metric is added by adding files and entries, never by editing one.

A driver module has three functions:

* ``setup(ctx) -> state``: makes the inputs from the seed, builds the
  program's objects and warms up every shape the window uses;
* ``window(ctx, state) -> record``: the timed loop, ``ctx.seconds`` long,
  ended by a synchronisation; the record holds what the metrics read;
* ``check(ctx, state, record, control=False) -> {name: value}``: frees
  the program's state, runs the plain reference and returns the numbers
  that the workload's ``limits`` hold (with ``control``, the numbers of
  the reference computed one precision lower, in the program's place).
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent
#: Top-level module names that no process of the benchmark may hold: JAX
#: and the JAX package ``repro`` (``repro_torch``, the port, is allowed).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Where a run writes: its result, its trace.  Inside the checkout.
OUT = ROOT / "build" / "perfbench"


def load_json(path: pathlib.Path) -> Any:
    """The JSON document at ``path``."""
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    """The ``workloads`` entry of cell ``name`` (KeyError if absent)."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def workload(name: str) -> dict:
    """``workloads/<name>.json``: one cell's traffic, driver and limits."""
    return load_json(PB / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    """``configs/<name>.json``: one configuration."""
    return load_json(PB / "configs" / f"{name}.json")


def load_module(path: pathlib.Path, prefix: str):
    """Import the Python file at ``path`` under a private module name
    (metric files carry dots in their names)."""
    mod_name = prefix + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """The traffic driver ``traffic/<name>.py``."""
    return load_module(PB / "traffic" / f"{name}.py", "perfbench_traffic_")


def metric_reader(name: str):
    """The reader ``metrics/<name>.py`` (its ``read(run)``)."""
    return load_module(PB / "metrics" / f"{name}.py", "perfbench_metric_")


def selected_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (those listing the cell, or without
    a list, those moving an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def stated_dtype(cfg: dict) -> str:
    """The element type a configuration states (``torch_dtype``).  The
    drivers' inputs, byte counts and control (TF32 operands) are made for
    float32; a configuration that states another type is refused here
    rather than run in a type it does not state."""
    dtype = cfg["torch_dtype"]
    if dtype != "float32":
        raise ValueError(f"configuration {cfg['name']!r} states "
                         f"torch_dtype {dtype!r}; the drivers run float32")
    return dtype


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed``: the
    same seed and tags give the same number on every machine."""
    text = "|".join([str(int(seed))] + [str(t) for t in tags])
    digest = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def generator(torch, device, seed: int, *tags):
    """A ``torch.Generator`` on ``device`` for the stream ``tags``."""
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, *tags))
    return g


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is in ``FORBIDDEN``."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def prepare_environment() -> None:
    """Cache directories at fixed paths inside the checkout, the port on
    ``sys.path``, and no tuned-tile cache: the port's static tiles.

    Byte-code too: where the environment says not to write it
    (``PYTHONDONTWRITEBYTECODE``) or the installation is read-only, every
    process compiles torch's Python sources again, seconds of set-up.
    Cached in the checkout, only its first run compiles them."""
    build = ROOT / "build"
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(build / "pycache")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("REPRO_TORCH_TUNED_JSON", None)
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def nvidia_smi() -> Optional[Dict[str, str]]:
    """The first card's name, power limit and draw, clocks and temperature
    as ``nvidia-smi`` reads them (None where it cannot)."""
    fields = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.mem",
              "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    first = out.strip().splitlines()[0] if out.strip() else ""
    vals = [v.strip() for v in first.split(",")]
    return dict(zip(fields, vals)) if len(vals) == len(fields) else None


def power_limit_w(smi: Optional[Dict[str, str]]) -> Optional[float]:
    """The power limit in watts from an ``nvidia_smi`` reading."""
    try:
        return float(smi["power.limit"]) if smi else None
    except (KeyError, ValueError):
        return None


def percentile(values: List[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile (0 < p <= 100)."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    return s[max(0, math.ceil(p / 100.0 * len(s)) - 1)]


@dataclasses.dataclass
class Context:
    """What a driver's functions get: the cell's files, the seed and the
    window, the device, the sub-window tracer and a logger."""

    torch: Any
    cell: str
    config: dict
    workload: dict
    seed: int
    seconds: float
    device: str
    tracer: Any
    log: Callable[[str], None]

    @property
    def backend(self) -> str:
        """The port's backend: its CUDA kernels on the card, their plain
        versions on the CPU (the tests')."""
        return "cuda" if self.device.startswith("cuda") else "plain"

    def sync(self) -> None:
        """Wait for the device (a no-op on the CPU)."""
        if self.device.startswith("cuda"):
            self.torch.cuda.synchronize()


@dataclasses.dataclass
class RunData:
    """What a metric reader reads."""

    cell: str
    config: dict
    workload: dict
    setup_s: float
    record: dict
    trace: Any = None
    peaks: Optional[dict] = None


def peaks_for(device_name: str) -> Optional[dict]:
    """The datasheet peaks of the card named ``device_name``, or None."""
    table = load_json(PB / "costs" / "peaks.json")
    return table.get(device_name)


def judge(checks: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; a number is within its limit when it
    is finite and at most the limit."""
    missing = sorted(set(limits) - set(checks))
    if missing:
        raise KeyError(f"the check gave no number for {missing}")
    return {k: {"value": float(checks[k]), "limit": float(limits[k])}
            for k in limits}


def failing(judged: Dict[str, Dict[str, float]]) -> List[str]:
    """Names of the numbers outside their limits."""
    return [k for k, v in judged.items()
            if not (math.isfinite(v["value"]) and v["value"] <= v["limit"])]


def _libraries() -> set:
    build = ROOT / "build"
    return {str(p) for p in build.rglob("*.so")} if build.exists() else set()


def build_kernels(ctx: Context) -> None:
    """Build the port's kernels now, in set-up, if the port has a build
    step (``kernels._ext.build``), and say whether this run compiled."""
    from repro_torch.kernels import _ext
    before = _libraries()
    t = time.perf_counter()
    build = getattr(_ext, "build", None)
    if build is not None:
        build()
    new = len(_libraries() - before)
    what = f"compiled {new} libraries" if new else "nothing compiled (cached)"
    ctx.log(f"build: {what} in {time.perf_counter() - t:.1f} s")


def reset_launches() -> None:
    """Zero the port's per-kernel launch counts, where it keeps them."""
    from repro_torch.kernels import _ext
    reset = getattr(_ext, "reset_launches", None)
    if reset is not None:
        reset()


def launches() -> Dict[str, int]:
    """The port's launches per kernel since ``reset_launches``."""
    from repro_torch.kernels import _ext
    return dict(sorted(getattr(_ext, "LAUNCHES", {}).items()))


def free(ctx: Context) -> None:
    """Collect what the program left and return the card's cached blocks,
    so that the reference runs in the memory the program held."""
    gc.collect()
    if ctx.device.startswith("cuda"):
        ctx.torch.cuda.empty_cache()


def execute(ctx: Context, drv, t_start: float, control: bool = False):
    """Set-up, window and check of one run; returns (state-free) results:
    ``(setup_s, record, numbers)``."""
    torch = ctx.torch
    cuda = ctx.device.startswith("cuda")
    t = time.perf_counter()
    if cuda:
        torch.zeros(1, device=ctx.device)
        torch.cuda.reset_peak_memory_stats()
    ctx.log(f"setup: {t - t_start:.2f} s to the driver, "
            f"{time.perf_counter() - t:.2f} s of the card's context")
    state = drv.setup(ctx)
    setup_s = time.perf_counter() - t_start
    ctx.log(f"setup: {setup_s:.2f} s in all")
    record = drv.window(ctx, state)
    record["smi"] = nvidia_smi() if cuda else None
    ctx.log(f"the card after the window: {record['smi']}")
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if cuda else 0)
    bad = forbidden_modules()
    if bad:
        raise ImportGuardError(bad)
    numbers = drv.check(ctx, state, record, control=control)
    del state
    free(ctx)
    return setup_s, record, numbers


class ImportGuardError(RuntimeError):
    """A forbidden module was loaded in the process."""

    def __init__(self, names: List[str]):
        super().__init__(f"forbidden modules loaded: {names}")
        self.names = names
