"""``attn_proj_roofline.decode``: the share (%) of its bound that a decode
step's attention projections reached in the traced sub-window: the
device operations whose innermost program range is ``model.attention``
(the input norm, q / k / v, RoPE, the cache-row write, o; flash-decode,
inside its own ``dispatch.attention``, is not among them), against
``costs.decode_parts.attention_proj`` a profiled step
(``harness.program_spans``)."""
from perfbench.costs import decode_parts
from perfbench.harness import program_spans


def read(run):
    work = decode_parts.attention_proj(run.config, run.record["batch"])
    return program_spans.roofline(
        run, ["model.attention"],
        program_spans.decode_work(run, lambda kv_len: work))
