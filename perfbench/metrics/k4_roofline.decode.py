"""``k4_roofline.decode``: the share (%) of its bound that K4,
flash-decode in every layer of a decode step, reached in the traced
sub-window: each launch inside the driver's ``pb.k4`` range
(``harness.readers.roofline``)."""
from perfbench.harness.readers import roofline


def read(run):
    return roofline(run, ["pb.k4"])
