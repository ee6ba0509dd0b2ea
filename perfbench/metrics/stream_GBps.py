"""``stream_GBps``: the bytes all of the window's calls need
(``costs.kernels``), over all of the window's time, in GB/s (host clock
around a window that ends in a synchronisation)."""


def read(run):
    rec = run.record
    if "bytes" not in rec or rec["seconds"] <= 0:
        return None
    return rec["bytes"] / rec["seconds"] / 1e9
