"""``step_mfu.decode``: the whole decode step's share (%) of the card's
peak on its binding resource: per step the larger of its bytes over the
HBM rate and its operations over the float32 peak (``costs.decode`` at
that step's kv_len), summed over the window's steps before any profiled
stretch, over their wall time (host clock, up to a synchronisation)."""
from perfbench.costs import bound_s
from perfbench.costs import decode


def read(run):
    rec, peaks = run.record, run.peaks
    n = rec.get("pre_steps", 0)
    if peaks is None or n <= 0 or rec["pre_seconds"] <= 0:
        return None
    total = sum(bound_s(*decode.step(run.config, rec["batch"], kv), peaks)
                for kv in rec["kv_lens"][:n])
    return 100.0 * total / rec["pre_seconds"]
