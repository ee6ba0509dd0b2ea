"""Arithmetic the metric readers share.  A reader that finds nothing to
read returns None, and its metric is left out of the result line."""
from __future__ import annotations

from typing import Optional, Sequence

from perfbench.costs import bound_s


def roofline(run, prefixes: Sequence[str]) -> Optional[float]:
    """The share (%) of its bound that the work in the ranges starting
    with ``prefixes`` reached: the frozen bound of the work the driver
    noted for those ranges, over the union of the device time of every
    operation launched inside them, over every unit profiled.

    None where there is no trace, no peak for this card, no such work, or
    any device operation of the window that no range claims (the time
    would then be short)."""
    tr = run.trace
    if tr is None or run.peaks is None or tr.unattributed:
        return None
    nbytes, flops = tr.work(prefixes)
    busy = tr.busy_s(prefixes, clip=False)
    if nbytes <= 0 or busy <= 0:
        return None
    return 100.0 * bound_s(nbytes, flops, run.peaks) / busy


def idle(run) -> Optional[float]:
    """The share (%) of the traced window in which no device operation
    ran."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
