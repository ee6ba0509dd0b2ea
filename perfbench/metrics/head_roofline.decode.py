"""``head_roofline.decode``: the share (%) of its bound that a decode
step's LM head reached in the traced sub-window: the device operations
launched inside the program's ``model.head`` range (the final norm and
the head's product), against ``costs.decode_parts.head`` a profiled
step (``harness.program_spans``)."""
from perfbench.costs import decode_parts
from perfbench.harness import program_spans


def read(run):
    work = decode_parts.head(run.config, run.record["batch"])
    return program_spans.roofline(
        run, ["model.head"],
        program_spans.decode_work(run, lambda kv_len: work))
