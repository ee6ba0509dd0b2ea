"""``moe_roofline.decode_latent``: the share (%) of its bound that a
decode step's MoE layers reached in the traced sub-window: the device
operations launched inside the program's ``model.moe`` ranges (the gate,
the held experts with their kernel's ``launch.experts``, the shared
experts), against ``costs.decode_latent.moe`` of each profiled step's
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
        b, f = decode_latent.moe(cfg, rec["batch"], t, r)
        nbytes, flops = nbytes + b, flops + f
    return program_spans.roofline(run, ["model.moe", "launch.experts"],
                                  (nbytes, flops))
