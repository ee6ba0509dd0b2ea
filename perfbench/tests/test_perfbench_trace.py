"""Reading a Chrome trace: device operations are attributed to the
benchmark range that was innermost on the host at their launch, through
the launch's correlation id or its external id, and the readers' shares
come from that."""
import pytest

from perfbench.harness import core, readers, tracing

PEAKS = {"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1e15}


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _events():
    host = [_x("pb.window", "user_annotation", 100, 1000),
            _x("pb.a", "user_annotation", 110, 50, **{"External id": 1}),
            _x("aten::empty", "cpu_op", 112, 5, **{"External id": 2}),
            _x("cudaLaunchKernel", "cuda_runtime", 120, 4, correlation=11),
            _x("pb.b", "user_annotation", 200, 50, **{"External id": 3}),
            _x("aten::mm", "cpu_op", 205, 20, **{"External id": 4})]
    dev = [_x("ka", "kernel", 300, 200, tid=7, correlation=11),
           _x("kb", "kernel", 450, 150, tid=7, correlation=99,
              **{"External id": 4}),
           _x("kc", "kernel", 900, 300, tid=7, correlation=98,
              **{"External id": 3}),
           _x("early", "kernel", 40, 20, tid=7, correlation=97,
              **{"External id": 1})]
    return host + dev


def test_attribution_and_shares():
    tr = tracing.parse(_events(), {"work": {"pb.a": [500e3, 0.0],
                                            "pb.b": [250e3, 0.0]}})
    by = {op.name: op for op in tr.ops}
    assert by["ka"].range == "pb.a"          # by correlation
    assert by["kb"].range == "pb.b"
    assert by["kc"].range == "pb.b"          # by external id
    assert by["early"].range == "pb.a"
    assert tr.unattributed == 0
    assert tr.window_s == pytest.approx(1000e-6)
    # [300, 600) and [900, 1100) inside the window [100, 1100)
    assert tr.busy_s() == pytest.approx(500e-6)
    assert tr.busy_s(["pb.b"]) == pytest.approx((600 - 450 + 200) * 1e-6)
    assert tr.busy_s(["pb.a"], clip=False) == pytest.approx(220e-6)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["between ranges", pytest.approx(300e-6)]  # [600, 900)
    assert gaps[1] == ["pb.b", pytest.approx(200e-6)]            # [100, 300)
    run = core.RunData("c", {}, {}, 1.0, {}, tr, PEAKS)
    # pb.a: 500 kB in 220 us of device time; the bound is 0.5 us
    assert readers.roofline(run, ["pb.a"]) == pytest.approx(
        100 * 0.5e-6 / 220e-6)
    assert readers.idle(run) == pytest.approx(50.0)
    assert tr.top_ops(1) == [["kc", pytest.approx(300e-6)]]


def test_an_unattributed_operation_silences_the_rooflines():
    events = _events() + [_x("lost", "kernel", 700, 10, tid=7,
                             correlation=5)]
    tr = tracing.parse(events, {"work": {"pb.a": [1.0, 0.0]}})
    assert tr.unattributed == 1
    run = core.RunData("c", {}, {}, 1.0, {}, tr, PEAKS)
    assert readers.roofline(run, ["pb.a"]) is None
    assert readers.idle(run) is not None


def test_no_window_range_is_an_error():
    with pytest.raises(ValueError):
        tracing.parse([_x("k", "kernel", 0, 1, correlation=1)])
