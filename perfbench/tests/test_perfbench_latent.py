"""The DeepSeek-V2 decode cell's driver end to end on the CPU at a tiny
size (set-up, window, check, metrics), with a tiny configuration of its
own cut from the committed one, and ``costs.decode_latent`` against hand
counts at the committed sizes.

A broken program comes out not correct: latent rows that are never
written, a routing that moves one token to another expert, a token
altered where it is produced.  The control (the reference in TF32 in the
program's place) comes out not correct on each of three seeds.
"""
import copy
import gzip
import json
import time

import pytest
import torch

from perfbench.costs import decode_latent
from perfbench.harness import core, tracing
from perfbench.harness.runner import run_files

CELL = "deepseek-v2-ep8-pp10.decode32k"
#: The committed configuration's widths cut to a CPU size: 4 of 16
#: experts held (8 groups of 2, 3 groups and 3 experts a token).
SIZES = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "q_lora_rank": 24, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "intermediate_size": 128, "moe_intermediate_size": 16,
         "num_hidden_layers": 3, "vocab_size": 512, "n_routed_experts": 4,
         "n_routed_experts_published": 16, "expert_start": 4,
         "num_experts_per_tok": 3}
TRAFFIC = {"batch": 2, "history": 48, "cache_len": 112, "warmup_steps": 2,
           "warmup_s": 0.0,
           "logit_stride": 4, "check_block": 8, "events": 0,
           "trace_after_s": 0.05, "trace_units": 3, "trace_lead": 1}


def tiny():
    bench = core.benchmark()
    entry = core.cell_entry(bench, CELL)
    cfg = copy.deepcopy(core.config(entry["config"]))
    cfg.update(SIZES)
    cfg["rope_scaling"] = dict(cfg["rope_scaling"],
                               original_max_position_embeddings=64)
    wl = dict(core.workload(CELL), **TRAFFIC)
    return bench, cfg, wl


def run(seed=7, seconds=0.3, trace=False, control=False, logs=None, **wl_kw):
    bench, cfg, wl = tiny()
    wl.update(wl_kw)
    log = logs.append if logs is not None else (lambda m: None)
    return run_files(torch, bench=bench, cell=CELL, cfg=cfg, wl=wl,
                     seed=seed, seconds=seconds, trace=trace, device="cpu",
                     t_start=time.perf_counter(), log=log, control=control)


def test_unbroken_run_is_correct():
    logs = []
    result = run(logs=logs)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {"logit_gap", "logits_err",
                                     "latent_err", "routing_err",
                                     "tie_share"}
    assert result["checks"]["routing_err"]["value"] == 0.0
    assert result["checks"]["tie_share"]["value"] == 0.0
    assert "setup_s" in result["metrics"]
    assert any("routing near-ties" in line for line in logs)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(seed):
    result = run(seed=seed, control=True)
    assert result["correct"] is False, result["checks"]


def _step_fault(monkeypatch, wrap):
    from repro_torch.models.engine import DecodeEngine
    monkeypatch.setattr(DecodeEngine, "decode_step",
                        wrap(DecodeEngine.decode_step))


def test_unwritten_latent_rows_are_not_correct(monkeypatch):
    def wrap(orig):
        def broken(self, tokens, caches, index):
            saved = [(c["latent"][:, :, index].clone(), c)
                     for c in caches.values()]
            out = orig(self, tokens, caches, index)
            for rows, c in saved:
                c["latent"][:, :, index] = rows
            return out
        return broken
    _step_fault(monkeypatch, wrap)
    result = run()
    assert result["correct"] is False
    assert result["checks"]["latent_err"]["value"] > \
        result["checks"]["latent_err"]["limit"]


def test_a_moved_route_is_not_correct(monkeypatch):
    from repro_torch.models import moe

    def moved(x, router, cfg, _route=moe.route):
        idx, w = _route(x, router, cfg)
        # the first token's best expert becomes the next held expert up
        first = idx[0, 0]
        held = cfg.expert_start + (first - cfg.expert_start + 1) % \
            cfg.n_experts
        idx = idx.clone()
        idx[0, 0] = held if held not in idx[0] else first
        return idx, w
    monkeypatch.setattr(moe, "route", moved)
    result = run()
    assert result["correct"] is False


def test_routes_the_reference_adopts_are_held_to_their_limit(monkeypatch):
    """A moved route inside a near-tie band so wide that the reference
    takes every choice of the program: ``routing_err`` reads 0, and
    ``tie_share`` fails the run."""
    from perfbench.reference import deepseek_v2
    from repro_torch.models import moe

    def moved(x, router, cfg, _route=moe.route):
        idx, w = _route(x, router, cfg)
        # the first token's last expert becomes one it passed over
        idx = idx.clone()
        first = idx[0, -1]
        held = cfg.expert_start + (first - cfg.expert_start + 1) % \
            cfg.n_experts
        idx[0, -1] = held if held not in idx[0] else first
        return idx, w
    monkeypatch.setattr(moe, "route", moved)
    monkeypatch.setattr(deepseek_v2, "TIE_TOL", 100.0)
    result = run()
    checks = result["checks"]
    assert checks["routing_err"]["value"] == 0.0, checks
    assert checks["tie_share"]["value"] > checks["tie_share"]["limit"]
    assert result["correct"] is False


def test_an_altered_token_is_not_correct(monkeypatch):
    def wrap(orig):
        def broken(self, tokens, caches, index):
            logits, caches = orig(self, tokens, caches, index)
            logits = logits.clone()
            logits[0] = logits[0].roll(1, dims=-1)
            return logits, caches
        return broken
    _step_fault(monkeypatch, wrap)
    assert run()["correct"] is False


def test_rewinds_start_new_requests_that_stay_correct():
    logs = []
    result = run(logs=logs, cache_len=TRAFFIC["history"] + 3)
    assert any(line.startswith("request: ") for line in logs)
    assert result["correct"] is True, result["checks"]


def _kept(seed):
    with gzip.open(core.OUT / CELL / f"seed{seed}.trace.json.gz", "rt") as f:
        events = json.load(f)["traceEvents"]
    main = next((e["pid"], e["tid"]) for e in events
                if e.get("name") == tracing.WINDOW)
    return [e["name"] for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and (e["pid"], e["tid"]) == main]


def test_traced_run_keeps_the_new_spans_and_reads_the_host():
    logs = []
    result = run(seed=21, trace=True, seconds=0.5, logs=logs)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["host_ms_per_step.decode"]["value"] > 0
    names = _kept(21)
    steps = names.count("model.decode_step")
    assert steps == names.count("pb.step") > 0
    layers, moe_layers = 3, 2
    assert names.count("model.mla") == layers * steps
    for span in ("model.moe.route", "model.moe.experts", "model.moe.shared",
                 "launch.experts"):
        assert names.count(span) == moe_layers * steps, span
    with open(core.OUT / CELL / "seed21.trace1.json") as f:
        window = json.load(f)["window"]
    assert len(window["moe_touched"]) == window["steps"]
    assert all(0 <= t <= moe_layers * SIZES["n_routed_experts"]
               for t in window["moe_touched"])


def test_a_port_without_the_expert_share_fails_at_once(monkeypatch):
    from repro_torch.models import config
    monkeypatch.delattr(config, "DeepSeekV2Config")
    with pytest.raises(ImportError):
        run()


def test_a_shares_weights_do_not_depend_on_the_experts_it_holds():
    drv = core.driver("decode_latent")
    _, cfg, _ = tiny()
    one = drv.layer_weights(torch, cfg, 5, 1, "cpu")
    two = drv.layer_weights(torch, dict(cfg, expert_start=6,
                                        n_routed_experts=2), 5, 1, "cpu")
    for k in ("moe.w_gate", "moe.w_up", "moe.w_down"):
        assert torch.equal(one[k][2:], two[k])
    assert torch.equal(one["moe.router"], two["moe.router"])


# --------------------------------------------------------------------------
# the frozen bytes and operations, by hand at the committed sizes
# --------------------------------------------------------------------------

CFG = core.config("deepseek-v2-ep8-pp10")


def test_mla_is_278528_flops_per_2304_bytes_a_position():
    """128 heads x (2 x 576 + 2 x 512) FLOPs for one 576-wide float32 row
    (2,304 bytes), plus the absorption and w_uv per token: 121 FLOP/B."""
    nbytes, flops = decode_latent.mla(CFG, 64, 30720)
    assert nbytes == 6 * 64 * 30720 * 2304
    per_token = 128 * (128 * 512 + 512 * 128) * 2
    assert flops == 6 * 64 * (30720 * 278_528 + per_token)
    assert flops / 6 / 1e9 == pytest.approx(548, rel=0.01)


def test_weights_are_the_issues_18_9_gb():
    """Embedding and head 4.19 GB, layer 0 1.35 GB, each MoE layer 2.68 GB
    (attention 0.60, 20 experts 1.89, shared 0.19)."""
    d, v = 5120, 102400
    head = d * v * 4
    attn = 128 * 0 + (5120 * 1536 + 1536 * 128 * 192 + 5120 * 576
                      + 512 * 128 * 256 + 128 * 128 * 5120) * 4
    assert attn == pytest.approx(0.597e9, rel=1e-3)
    assert decode_latent.other_weights(CFG) * 4 == \
        6 * attn + 3 * 5120 * 12288 * 4 + head
    # every held expert touched, in every MoE layer
    nbytes, _ = decode_latent.moe(CFG, 64, 5 * 20, 0)
    experts = 20 * 3 * 5120 * 1536 * 4
    shared = 2 * 3 * 5120 * 1536 * 4
    router = 5120 * 160 * 4
    assert nbytes == 5 * (experts + shared + router)
    total = decode_latent.other_weights(CFG) * 4 + nbytes + d * v * 4
    assert total / 1e9 == pytest.approx(18.9, abs=0.05)


def test_moe_counts_touched_experts_and_routed_rows():
    nbytes, flops = decode_latent.moe(CFG, 64, 90, 240)
    expert = 3 * 5120 * 1536
    per_layer = 5120 * 160 + 2 * expert
    assert nbytes == (5 * per_layer + 90 * expert) * 4
    assert flops == 2 * (5 * 64 * per_layer + 240 * expert)
    kb, kf = decode_latent.experts(CFG, 90, 240)
    assert kb == (90 * expert + 240 * (2 * 5120 + 2 * 1536)) * 4
    assert kf == 2 * 240 * expert


def test_the_step_is_its_parts():
    batch, kv, touched, rows = 64, 28673, 90, 240
    step = decode_latent.step(CFG, batch, kv, touched, rows)
    mla = decode_latent.mla(CFG, batch, kv)
    moe = decode_latent.moe(CFG, batch, touched, rows)
    w = decode_latent.other_weights(CFG)
    wkv_b = 6 * 512 * 128 * 256
    assert step[1] == 2 * batch * (w - wkv_b) + mla[1] + moe[1]
    assert step[0] == (w + 6 * batch * 576) * 4 + batch * 102400 * 4 + \
        mla[0] + moe[0]
    # compute-bound: the whole step's bound is its operations
    peaks = core.peaks_for("NVIDIA H100 80GB HBM3")
    assert step[1] / peaks["fp32_flops_per_s"] > \
        step[0] / peaks["hbm_bytes_per_s"]
