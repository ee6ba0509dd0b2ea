"""The program's own ranges: device operations are attributed to the
innermost ``model.*`` / ``dispatch.*`` / ``launch.*`` range at their
launch, inside the benchmark's ``pb.*`` ranges; the per-sublayer shares
read them from the run's kept trace; the parts of a decode step add up
to the whole step; and a traced run of a decode cell keeps one
``model.decode_step`` range per ``pb.step``."""
import gzip
import json

import pytest

from perfbench.costs import bound_s, decode, decode_parts, kernels
from perfbench.harness import core, program_spans, tracing
from perfbench.tests import tiny

PEAKS = {"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1e15}
CELL = "mistral-nemo-12b-pp4.decode32k.vector"
METRICS = ("k4_launch_roofline.decode", "attn_proj_roofline.decode",
           "mlp_roofline.decode", "head_roofline.decode")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _events(program=True, window_ts=100):
    """One profiled step: the program's ranges inside ``pb.step``, a
    kernel of each sublayer launched by correlation id, the MLP's by
    external id, and the argmax outside ``model.decode_step``."""
    host = [_x("pb.window", "user_annotation", window_ts, 2000),
            _x("pb.step", "user_annotation", 110, 1000)]
    if program:
        host += [
            _x("model.decode_step", "user_annotation", 115, 875),
            _x("model.attention", "user_annotation", 120, 280),
            _x("dispatch.attention", "user_annotation", 200, 100),
            _x("launch.attention.vector", "user_annotation", 210, 80),
            _x("model.mlp", "user_annotation", 400, 200),
            _x("model.head", "user_annotation", 600, 300),
            # another thread's range claims nothing
            _x("model.mlp", "user_annotation", 0, 5000, tid=2)]
    host += [_x("cudaLaunchKernel", "cuda_runtime", 130, 4, correlation=1),
             _x("cudaLaunchKernel", "cuda_runtime", 220, 4, correlation=2),
             _x("cudaLaunchKernel", "cuda_runtime", 230, 4, correlation=3),
             _x("aten::mm", "cpu_op", 450, 20, **{"External id": 5}),
             _x("cudaLaunchKernel", "cuda_runtime", 650, 4, correlation=4),
             _x("cudaLaunchKernel", "cuda_runtime", 995, 4, correlation=6)]
    dev = [_x("proj", "kernel", 1000, 100, tid=7, correlation=1),
           _x("k4_range", "kernel", 1100, 200, tid=7, correlation=2),
           _x("k4_combine", "kernel", 1250, 100, tid=7, correlation=3),
           _x("gemm", "kernel", 1350, 400, tid=7, correlation=99,
              **{"External id": 5}),
           _x("head", "kernel", 1750, 100, tid=7, correlation=4),
           _x("argmax", "kernel", 1850, 10, tid=7, correlation=6)]
    return host + dev


def _cfg():
    return dict(tiny.cell(CELL)[1])


def _run(tmp_path, monkeypatch, events, kept=None):
    """RunData of one profiled step at kv_len 40 (after 3 unprofiled
    steps), the trace kept as the harness keeps it."""
    monkeypatch.setattr(core, "OUT", tmp_path)
    out = tmp_path / CELL
    out.mkdir(parents=True, exist_ok=True)
    with gzip.open(out / "seed1.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events if kept is None else kept}, f)
    cfg, wl = _cfg(), {"cache_len": 64}
    record = {"batch": 2, "pre_steps": 3, "kv_lens": [37, 38, 39, 40, 41]}
    return core.RunData(CELL, cfg, wl, 1.0, record,
                        tracing.parse(events), PEAKS)


def test_ops_take_the_innermost_program_range_inside_the_step():
    tr = program_spans.parse(_events())
    by = {op.name: op.range for op in tr.ops}
    assert by == {"proj": "model.attention",
                  "k4_range": "launch.attention.vector",
                  "k4_combine": "launch.attention.vector",
                  "gemm": "model.mlp",             # by external id
                  "head": "model.head",
                  "argmax": None}                  # pb.step alone
    assert tr.count("model.decode_step") == 1
    assert tr.busy_s(["dispatch.attention", "launch.attention."],
                     clip=False) == pytest.approx(250e-6)
    # the benchmark's own attribution is unchanged by the program's ranges
    assert {op.range for op in tracing.parse(_events()).ops} == {"pb.step"}


def test_each_reader_reads_its_sublayer(tmp_path, monkeypatch):
    run = _run(tmp_path, monkeypatch, _events())
    cfg = run.config
    kh = cfg["num_key_value_heads"]
    k4 = kernels.flash_decode(2, kh, cfg["num_attention_heads"] // kh,
                              cfg["head_dim"], 64, 40, 4)
    layers = cfg["num_hidden_layers"]
    want = {
        "k4_launch_roofline.decode": (
            (layers * k4[0], layers * k4[1]), 250e-6),
        "attn_proj_roofline.decode": (
            decode_parts.attention_proj(cfg, 2), 100e-6),
        "mlp_roofline.decode": (decode_parts.mlp(cfg, 2), 400e-6),
        "head_roofline.decode": (decode_parts.head(cfg, 2), 100e-6)}
    for name in METRICS:
        work, busy = want[name]
        got = core.metric_reader(name).read(run)
        assert got == pytest.approx(100 * bound_s(*work, PEAKS) / busy), \
            name


@pytest.mark.parametrize("case", ["no program range", "no file matches",
                                  "no file"])
def test_readers_are_silent_with_nothing_to_read(tmp_path, monkeypatch,
                                                 case):
    if case == "no program range":
        run = _run(tmp_path, monkeypatch, _events(program=False))
    elif case == "no file matches":
        run = _run(tmp_path, monkeypatch, _events(),
                   kept=_events(window_ts=101))
    else:
        monkeypatch.setattr(core, "OUT", tmp_path)
        run = core.RunData(CELL, _cfg(), {"cache_len": 64}, 1.0,
                           {"batch": 2, "pre_steps": 0, "kv_lens": [40]},
                           tracing.parse(_events()), PEAKS)
    for name in METRICS:
        assert core.metric_reader(name).read(run) is None, name


@pytest.mark.parametrize("kv_len", [1, 28672, 32768])
@pytest.mark.parametrize("batch", [1, 16])
def test_the_parts_and_k4_make_the_whole_step(kv_len, batch):
    cfg = core.config("mistral-nemo-12b-pp4")
    kh, dh = cfg["num_key_value_heads"], cfg["head_dim"]
    g, layers = cfg["num_attention_heads"] // kh, cfg["num_hidden_layers"]
    parts = [decode_parts.attention_proj(cfg, batch),
             decode_parts.mlp(cfg, batch), decode_parts.head(cfg, batch)]
    k4 = kernels.flash_decode(batch, kh, g, dh, 32768, kv_len, 4)
    nbytes = sum(p[0] for p in parts) + layers * k4[0]
    flops = sum(p[1] for p in parts) + layers * k4[1]
    step = decode.step(cfg, batch, kv_len)
    assert flops == step[1]
    q_and_out = layers * 2 * batch * kh * g * dh * 4
    assert nbytes == step[0] + q_and_out


def test_mistral_parts_at_batch_16():
    """2.10, 8.81 and 2.69 GB a step: 0.626, 2.63 and 0.80 ms at
    3.35 TB/s."""
    cfg = core.config("mistral-nemo-12b-pp4")
    assert decode_parts.attention_proj(cfg, 16)[0] == 2_098_462_720
    assert decode_parts.mlp(cfg, 16)[0] == 8_808_038_400
    assert decode_parts.head(cfg, 16)[0] == 2_692_743_168


def _kept(seed):
    with gzip.open(core.OUT / CELL / f"seed{seed}.trace.json.gz", "rt") as f:
        events = json.load(f)["traceEvents"]
    main = next((e["pid"], e["tid"]) for e in events
                if e.get("name") == tracing.WINDOW)
    return [e["name"] for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and (e["pid"], e["tid"]) == main]


def test_traced_decode_keeps_one_step_range_per_pb_step(monkeypatch):
    from repro_torch.obs import trace as p_trace
    with_ranges = tiny.run(CELL, seed=11, trace=True, seconds=0.5)
    names = _kept(11)
    assert names.count("pb.step") > 0
    assert names.count("model.decode_step") == names.count("pb.step")
    # the same run with a program that opens no range of its own
    monkeypatch.setattr(p_trace, "_TORCH_PROFILER",
                        type("Off", (), {"_is_profiler_enabled": False}))
    without = tiny.run(CELL, seed=12, trace=True, seconds=0.5)
    assert not [n for n in _kept(12) if n.startswith(
        program_spans.PREFIXES)]
    for result in (with_ranges, without):
        assert result["correct"] is True, result["checks"]
    assert list(with_ranges) == list(without)
    assert set(with_ranges["metrics"]) == set(without["metrics"])
    assert set(with_ranges["checks"]) == set(without["checks"])
