"""``device_idle.stream``: the share (%) of the traced sub-window in
which no device operation ran."""
from perfbench.harness.readers import idle


def read(run):
    return idle(run)
