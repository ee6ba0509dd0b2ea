"""``k3_roofline.stream``: the share (%) of its bound that K3, the
stencils (2d5pt and 3d7pt) reached in the traced sub-window
(``harness.readers.roofline``)."""
from perfbench.harness.readers import roofline


def read(run):
    return roofline(run, ["pb.stencil"])
