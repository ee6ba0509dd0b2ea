"""``mlp_roofline.decode``: the share (%) of its bound that a decode
step's SwiGLU FFNs reached in the traced sub-window: the device
operations launched inside the program's ``model.mlp`` ranges (the input
norm and the three matrices), against ``costs.decode_parts.mlp`` a
profiled step (``harness.program_spans``)."""
from perfbench.costs import decode_parts
from perfbench.harness import program_spans


def read(run):
    work = decode_parts.mlp(run.config, run.record["batch"])
    return program_spans.roofline(
        run, ["model.mlp"],
        program_spans.decode_work(run, lambda kv_len: work))
