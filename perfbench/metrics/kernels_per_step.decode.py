"""``kernels_per_step.decode``: device kernels launched inside the decode
steps of the traced sub-window, per step."""


def read(run):
    tr = run.trace
    steps = tr.count("pb.step") if tr is not None else 0
    if steps <= 0 or tr.unattributed:
        return None
    kernels = [op for op in tr.select(["pb.step", "pb.k4"])
               if op.kind == "kernel"]
    return len(kernels) / steps if kernels else None
