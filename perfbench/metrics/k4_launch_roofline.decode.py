"""``k4_launch_roofline.decode``: the share (%) of its bound that K4,
flash-decode in every layer of a decode step, reached in the traced
sub-window, read from the program's own ranges: every device operation
launched inside its ``dispatch.attention`` range (``launch.attention.*``
nested in it), against ``costs.kernels.flash_decode`` at each profiled
step's kv_len in every layer (``harness.program_spans``)."""
from perfbench.costs import kernels
from perfbench.harness import program_spans


def read(run):
    cfg, wl = run.config, run.workload
    kh, layers = cfg["num_key_value_heads"], cfg["num_hidden_layers"]
    g = cfg["num_attention_heads"] // kh

    def per_step(kv_len):
        nbytes, flops = kernels.flash_decode(
            run.record["batch"], kh, g, cfg["head_dim"], wl["cache_len"],
            kv_len, 4)
        return layers * nbytes, layers * flops
    return program_spans.roofline(
        run, ["dispatch.attention", "launch.attention."],
        program_spans.decode_work(run, per_step))
