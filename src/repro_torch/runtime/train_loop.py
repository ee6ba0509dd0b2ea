"""Production training loop: checkpoint/restart, stragglers, failure drills.

The loop is restart-oriented: all state lives in (params, opt_state,
step); data is replayed deterministically from the step counter, so
``run()`` after a crash resumes bit-exact from the last complete
checkpoint.

Fault tolerance pieces:
  * atomic + async checkpoints every ``ckpt_every`` steps (``checkpoint``)
  * StragglerWatchdog -- EWMA step-time monitor; flags steps whose time
    exceeds ``threshold`` x the moving average
  * FailureInjector -- deterministic crash at step N for restart drills
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from . import checkpoint as ckpt

__all__ = ["FailureInjector", "StragglerWatchdog", "TrainLoopConfig", "run"]


class StragglerWatchdog:
    """EWMA step-time monitor (straggler mitigation signal)."""

    def __init__(self, alpha: float = 0.2, threshold: float = 2.0,
                 warmup: int = 3):
        self.alpha, self.threshold, self.warmup = alpha, threshold, warmup
        self.ewma: Optional[float] = None
        self.flagged: list = []
        self._n = 0

    def observe(self, step: int, dt: float) -> bool:
        """Record one step's time; True when it is a straggler."""
        self._n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = (self._n > self.warmup
                and dt > self.threshold * self.ewma)
        if slow:
            self.flagged.append((step, dt, self.ewma))
        # slow steps shouldn't poison the average
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * min(
            dt, self.ewma * self.threshold)
        return slow


class FailureInjector:
    """Deterministic crash for restart drills."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step

    def maybe_fail(self, step: int):
        """Raise ``RuntimeError`` at the configured step."""
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class TrainLoopConfig:
    """Steps, checkpoint cadence and directory, logging cadence."""

    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "ckpts"
    keep: int = 3
    log_every: int = 10
    async_ckpt: bool = True


def _wait(loss: torch.Tensor) -> None:
    """Block until the card has finished the step that made ``loss``."""
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)


def run(loop_cfg: TrainLoopConfig, *, init_state: Callable[[], tuple],
        step_fn: Callable, batch_fn: Callable[[int], Dict],
        watchdog: Optional[StragglerWatchdog] = None,
        injector: Optional[FailureInjector] = None,
        log: Callable[[str], None] = print) -> tuple:
    """Run to total_steps, resuming from the newest checkpoint if present.

    init_state() -> (params, opt_state); step_fn(params, opt_state, batch)
    -> (params, opt_state, metrics); batch_fn(step) must be deterministic.
    Returns (params, opt_state, the last step's metrics).
    """
    params, opt_state = init_state()
    start = 0
    resumed = ckpt.latest_step(loop_cfg.ckpt_dir)
    if resumed is not None:
        params, opt_state = ckpt.restore(loop_cfg.ckpt_dir,
                                         (params, opt_state), step=resumed)
        start = resumed
        log(f"[resume] from step {start}")

    writer = ckpt.AsyncCheckpointer(loop_cfg.ckpt_dir)
    metrics = {}
    for step in range(start, loop_cfg.total_steps):
        if injector is not None:
            injector.maybe_fail(step)
        t0 = time.time()
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _wait(metrics["loss"])
        dt = time.time() - t0
        if watchdog is not None and watchdog.observe(step, dt):
            log(f"[straggler] step {step} took {dt:.3f}s "
                f"(ewma {watchdog.ewma:.3f}s)")
        if (step + 1) % loop_cfg.log_every == 0:
            log(f"step {step + 1}: loss={float(metrics['loss']):.4f} "
                f"({dt * 1e3:.0f} ms)")
        if (step + 1) % loop_cfg.ckpt_every == 0:
            if loop_cfg.async_ckpt:
                writer.save(step + 1, (params, opt_state))
            else:
                ckpt.save(loop_cfg.ckpt_dir, step + 1, (params, opt_state))
            ckpt.prune_old(loop_cfg.ckpt_dir, loop_cfg.keep)
    writer.wait()
    ckpt.save(loop_cfg.ckpt_dir, loop_cfg.total_steps, (params, opt_state))
    return params, opt_state, metrics
