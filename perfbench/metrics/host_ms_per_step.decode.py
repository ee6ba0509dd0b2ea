"""``host_ms_per_step.decode``: the host's own milliseconds per decode
step: the median, over the steps that set-up issues onto an idle card
(``decode_closed._host_probe``), of the time from the ``decode_step``
call to the return of its argmax.  No launch waits in a full queue there,
so this reads what the engine, the dispatcher and the launch path cost
the host, not the card's pace."""
from perfbench.harness import core


def read(run):
    ms = run.record.get("host_ms")
    return core.percentile(ms, 50) if ms else None
