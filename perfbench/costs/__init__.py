"""The yardstick's frozen arithmetic: the bytes and operations each
kernel call and each decode step needs (``kernels``, ``decode``), and the
cards' datasheet peaks (``peaks.json``).

A roofline share divides the least time the card could take, the larger
of bytes over the HBM rate and operations over the float32 peak, by the
measured device time.  Each input byte is counted read once and each
output byte written once, whatever a kernel reads again.
"""


def bound_s(nbytes: float, flops: float, peaks: dict) -> float:
    """The least seconds ``nbytes`` and ``flops`` take on a card with
    ``peaks`` (``hbm_bytes_per_s``, ``fp32_flops_per_s``)."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["fp32_flops_per_s"])
