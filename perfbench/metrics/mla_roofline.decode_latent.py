"""``mla_roofline.decode_latent``: the share (%) of its bound that a
decode step's absorbed latent attention reached in the traced
sub-window: the device operations launched inside the program's
``model.mla`` ranges (absorb, scores, softmax, weighted sum, ``w_uv``),
against ``costs.decode_latent.mla`` at each profiled step's kv_len
(``harness.program_spans``)."""
from perfbench.costs import decode_latent
from perfbench.harness import program_spans


def read(run):
    cfg, b = run.config, run.record["batch"]
    return program_spans.roofline(
        run, ["model.mla"],
        program_spans.decode_work(
            run, lambda kv_len: decode_latent.mla(cfg, b, kv_len)))
