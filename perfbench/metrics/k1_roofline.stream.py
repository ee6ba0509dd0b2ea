"""``k1_roofline.stream``: the share (%) of its bound that K1, the
elementwise kernels (SCALE and Triad) reached in the traced sub-window
(``harness.readers.roofline``)."""
from perfbench.harness.readers import roofline


def read(run):
    return roofline(run, ["pb.scale", "pb.triad"])
