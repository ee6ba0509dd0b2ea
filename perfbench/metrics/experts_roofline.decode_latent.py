"""``experts_roofline.decode_latent``: the share (%) of its bound that
the grouped expert kernel (``csrc/experts.cu``: each held expert's
SwiGLU over the rows routed to it) reached in the traced sub-window: the
device operations launched inside the program's ``launch.experts``
ranges, against ``costs.decode_latent.experts`` of each profiled step's
touched held experts and routed rows, as the program's device counters
counted them (``harness.program_spans``)."""
from perfbench.costs import decode_latent
from perfbench.harness import program_spans


def read(run):
    cfg, rec = run.config, run.record
    sp = program_spans.spans(run)
    steps = sp.count("model.decode_step") if sp is not None else 0
    pre = rec.get("pre_steps", 0)
    touched = rec.get("moe_touched", [])[pre:pre + steps]
    rows = rec.get("moe_rows", [])[pre:pre + steps]
    if steps <= 0 or len(touched) < steps:
        return None
    nbytes = flops = 0.0
    for t, r in zip(touched, rows):
        b, f = decode_latent.experts(cfg, t, r)
        nbytes, flops = nbytes + b, flops + f
    return program_spans.roofline(run, ["launch.experts"], (nbytes, flops))
