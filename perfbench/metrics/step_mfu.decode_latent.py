"""``step_mfu.decode_latent``: the whole decode step's share (%) of the
card's peak on its binding resource, read as ``step_mfu.decode`` reads
it: per step the larger of its bytes over the HBM rate and its
operations over the float32 peak (``costs.decode_latent.step`` at that
step's kv_len, touched held experts and routed rows, as the program's
device counters counted them), summed over the window's steps before any
profiled stretch, over their wall time (host clock, up to a
synchronisation)."""
from perfbench.costs import bound_s
from perfbench.costs import decode_latent


def read(run):
    rec, peaks = run.record, run.peaks
    n = rec.get("pre_steps", 0)
    touched, rows = rec.get("moe_touched", []), rec.get("moe_rows", [])
    if peaks is None or n <= 0 or rec["pre_seconds"] <= 0 \
            or len(touched) < n:
        return None
    total = sum(bound_s(*decode_latent.step(run.config, rec["batch"], kv,
                                            t, r), peaks)
                for kv, t, r in zip(rec["kv_lens"][:n], touched, rows))
    return 100.0 * total / rec["pre_seconds"]
