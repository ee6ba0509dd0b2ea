"""A whole run at a small size on the CPU, with the timed path broken
underneath, comes out not correct; the same run unbroken, correct; and
the control (the reference in TF32 in the program's place) not correct.

Faults, each planted in the port where its answer is produced:

* a step that returns its state unchanged: a stencil that hands back its
  input; a decode step that writes no K / V row into the cache;
* half of the batch left out, the mean taken over the rest: SCALE that
  computes the first half and fills the rest with its mean; a decode
  step that computes half of the sequences and gives the others their
  mean logits;
* an answer or a token altered where it is produced: one element of the
  attention output; one sequence's logits rolled, so its argmax moves.

The cells run on one card, so there is no exchange between cards to
leave out.
"""
import dataclasses
import time

import pytest
import torch

from perfbench.harness.runner import run_files
from perfbench.tests import tiny

STREAM = ["paper-stream-f32.vector", "paper-stream-f32.matrix"]
DECODE = ["mistral-nemo-12b-pp4.decode32k.vector",
          "mistral-nemo-12b-pp4.decode32k.matrix"]


def _replace_op(monkeypatch, name, wrap):
    from repro_torch.kernels import registry
    op = registry.get(name)
    engines = {eng: wrap(fn) for eng, fn in op.engines.items()}
    monkeypatch.setitem(registry._REGISTRY, name,
                        dataclasses.replace(op, engines=engines))


def _stencil_unchanged(fn):
    def broken(u, spec, **kw):
        fn(u, spec, **kw)
        return u.clone()
    return broken


def _scale_half(fn):
    def broken(b, q, **kw):
        out = fn(b, q, **kw)
        half = out.numel() // 2
        out.view(-1)[half:] = out.view(-1)[:half].mean()
        return out
    return broken


def _attention_altered(fn):
    def broken(*args, **kw):
        out = fn(*args, **kw)
        out.view(-1)[3] += 1.0
        return out
    return broken


STREAM_FAULTS = {"state_unchanged": ("stencil", _stencil_unchanged),
                 "half_the_batch": ("scale", _scale_half),
                 "answer_altered": ("attention", _attention_altered)}


@pytest.mark.parametrize("cell", STREAM)
@pytest.mark.parametrize("fault", sorted(STREAM_FAULTS))
def test_stream_fault_is_not_correct(monkeypatch, cell, fault):
    name, wrap = STREAM_FAULTS[fault]
    _replace_op(monkeypatch, name, wrap)
    result = tiny.run(cell)
    assert result["correct"] is False
    assert result["failed"] >= 1


def _decode_no_row(orig):
    def broken(self, tokens, caches, index):
        k = caches["attn"]["k"][:, :, index].clone()
        v = caches["attn"]["v"][:, :, index].clone()
        out = orig(self, tokens, caches, index)
        caches["attn"]["k"][:, :, index] = k
        caches["attn"]["v"][:, :, index] = v
        return out
    return broken


def _decode_half(orig):
    def broken(self, tokens, caches, index):
        logits, caches = orig(self, tokens, caches, index)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:half].mean(0, keepdim=True)
        return logits, caches
    return broken


def _decode_token_altered(orig):
    def broken(self, tokens, caches, index):
        logits, caches = orig(self, tokens, caches, index)
        logits = logits.clone()
        logits[0] = logits[0].roll(1, dims=-1)
        return logits, caches
    return broken


DECODE_FAULTS = {"state_unchanged": _decode_no_row,
                 "half_the_batch": _decode_half,
                 "token_altered": _decode_token_altered}


@pytest.mark.parametrize("cell", DECODE)
@pytest.mark.parametrize("fault", sorted(DECODE_FAULTS))
def test_decode_fault_is_not_correct(monkeypatch, cell, fault):
    from repro_torch.models.engine import DecodeEngine
    monkeypatch.setattr(DecodeEngine, "decode_step",
                        DECODE_FAULTS[fault](DecodeEngine.decode_step))
    result = tiny.run(cell)
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.parametrize("cell", STREAM + DECODE)
def test_unbroken_run_is_correct(cell):
    result = tiny.run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("cell", STREAM + DECODE)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(cell, seed):
    result = tiny.run(cell, seed=seed, control=True)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", STREAM + DECODE)
def test_traced_run_reports_its_per_layer_metrics_and_trace(cell):
    result = tiny.run(cell, trace=True, seconds=0.5)
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", DECODE)
def test_rewinds_start_new_requests_that_stay_correct(cell):
    logs = []
    result = tiny.run(cell, logs=logs, cache_len=tiny.DECODE["history"] + 3)
    assert any(line.startswith("request: ") for line in logs)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("cell", DECODE)
def test_traced_decode_reads_the_host_on_an_idle_card(cell):
    logs = []
    result = tiny.run(cell, trace=True, seconds=0.5, logs=logs)
    assert result["metrics"]["host_ms_per_step.decode"]["value"] > 0
    assert any(line.startswith("host probe: 16 steps") for line in logs)


@pytest.mark.parametrize("cell", STREAM + DECODE)
def test_a_configuration_stating_another_dtype_is_refused(cell):
    bench, cfg, wl = tiny.cell(cell)
    cfg["torch_dtype"] = "bfloat16"
    with pytest.raises(ValueError, match="bfloat16"):
        run_files(torch, bench=bench, cell=cell, cfg=cfg, wl=wl, seed=7,
                  seconds=0.3, trace=False, device="cpu",
                  t_start=time.perf_counter(), log=lambda m: None)
