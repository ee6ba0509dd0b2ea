"""``k2_roofline.stream``: the share (%) of its bound that K2, block-ELL
SpMV reached in the traced sub-window (``harness.readers.roofline``)."""
from perfbench.harness.readers import roofline


def read(run):
    return roofline(run, ["pb.spmv"])
