"""``k4_roofline.stream``: the share (%) of its bound that K4, flash-
decode at the suite's point reached in the traced sub-window
(``harness.readers.roofline``)."""
from perfbench.harness.readers import roofline


def read(run):
    return roofline(run, ["pb.attention"])
