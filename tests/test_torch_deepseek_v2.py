"""DeepSeek-V2's expert share, group-limited gate, YaRN and interleaved
rope in the port, against the plain reference
``perfbench/reference/deepseek_v2.py`` and against formulas written out
here, at a small size on the CPU with seeded random weights.

Tolerances: float32 sums taken in other orders (the share's per-token
sum over its slots against the reference's per-expert ``index_add_``,
the absorbed decode against the decompressed one), so outputs atol 1e-5
and rtol 1e-4, the engine's logits and latent rows atol 2e-5 and rtol
1e-4; routing exactly equal; YaRN's frequencies 1e-6 relative (float32
``pow`` against float64).
"""
import dataclasses
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench.reference import deepseek_v2 as ref  # noqa: E402
from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.models import layers as p_layers  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.models import moe as p_moe  # noqa: E402
from repro_torch.models.config import (  # noqa: E402
    DeepSeekV2Config, ExpertShareConfig, ModelConfig, YarnRopeConfig,
    yarn_mscale)
from repro_torch.models.engine import DecodeEngine  # noqa: E402
from repro_torch.obs.record import RECORD  # noqa: E402

#: A small DeepSeek-V2 as its configuration file names the sizes: 16
#: routed experts in 8 groups of 2, 3 groups and 3 experts a token.
TINY = {
    "hidden_size": 64, "num_attention_heads": 4, "q_lora_rank": 24,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "intermediate_size": 128, "moe_intermediate_size": 16,
    "first_k_dense_replace": 1, "num_hidden_layers": 3, "vocab_size": 512,
    "n_routed_experts": 16, "n_routed_experts_published": 16,
    "expert_start": 0, "n_group": 8, "topk_group": 3,
    "num_experts_per_tok": 3, "n_shared_experts": 2,
    "norm_topk_prob": False, "routed_scaling_factor": 16.0,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 64,
                     "type": "yarn"},
}


def port_config(c: dict, **changes) -> DeepSeekV2Config:
    rs = c["rope_scaling"]
    cfg = DeepSeekV2Config(
        name="deepseek-v2-tiny", family="moe",
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_attention_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], rope_theta=c["rope_theta"],
        norm_eps=c["rms_norm_eps"], use_mla=True,
        kv_lora_rank=c["kv_lora_rank"], q_lora_rank=c["q_lora_rank"],
        qk_nope_dim=c["qk_nope_head_dim"], qk_rope_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], n_experts=c["n_routed_experts"],
        top_k=c["num_experts_per_tok"],
        n_shared_experts=c["n_shared_experts"],
        moe_d_ff=c["moe_intermediate_size"],
        first_dense_layers=c["first_k_dense_replace"],
        dense_d_ff=c["intermediate_size"],
        router_experts=c["n_routed_experts_published"],
        expert_start=c["expert_start"], n_groups=c["n_group"],
        topk_groups=c["topk_group"],
        routed_scale=float(c["routed_scaling_factor"]),
        yarn_factor=float(rs["factor"]),
        yarn_original_len=rs["original_max_position_embeddings"],
        yarn_beta_fast=float(rs["beta_fast"]),
        yarn_beta_slow=float(rs["beta_slow"]),
        yarn_mscale=float(rs["mscale"]),
        yarn_mscale_all_dim=float(rs["mscale_all_dim"]))
    return dataclasses.replace(cfg, **changes)


def _draw(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def _moe_weights(gen, c: dict, experts: int) -> dict:
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    fs = f * c["n_shared_experts"]
    return {"moe.router": _draw(gen, d, c["n_routed_experts_published"],
                                scale=d ** -0.5),
            "moe.w_gate": _draw(gen, experts, d, f, scale=d ** -0.5),
            "moe.w_up": _draw(gen, experts, d, f, scale=d ** -0.5),
            "moe.w_down": _draw(gen, experts, f, d, scale=f ** -0.5),
            "moe.shared.w_gate": _draw(gen, d, fs, scale=d ** -0.5),
            "moe.shared.w_up": _draw(gen, d, fs, scale=d ** -0.5),
            "moe.shared.w_down": _draw(gen, fs, d, scale=fs ** -0.5)}


def _layer_weights(gen, c: dict, i: int) -> dict:
    d, h = c["hidden_size"], c["num_attention_heads"]
    qr, r = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rd, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])

    def norm(n):
        return 1.0 + _draw(gen, n, scale=0.1)
    w = {"ln1": norm(d), "ln2": norm(d),
         "attn.wq_a": _draw(gen, d, qr, scale=d ** -0.5),
         "attn.q_norm": norm(qr),
         "attn.wq_b": _draw(gen, qr, h * (nope + rd), scale=qr ** -0.5),
         "attn.wkv_a": _draw(gen, d, r + rd, scale=d ** -0.5),
         "attn.kv_norm": norm(r),
         "attn.wkv_b": _draw(gen, r, h * (nope + vd), scale=r ** -0.5),
         "attn.wo": _draw(gen, h * vd, d, scale=(h * vd) ** -0.5)}
    if i < c["first_k_dense_replace"]:
        f = c["intermediate_size"]
        w.update({"mlp.w_gate": _draw(gen, d, f, scale=d ** -0.5),
                  "mlp.w_up": _draw(gen, d, f, scale=d ** -0.5),
                  "mlp.w_down": _draw(gen, f, d, scale=f ** -0.5)})
    else:
        w.update(_moe_weights(gen, c, c["n_routed_experts"]))
    return w


def _model(c: dict, seed: int = 0):
    """(per-layer weights as the reference takes them, the outer weights,
    the port's LM over the same tensors)."""
    gen = torch.Generator().manual_seed(seed)
    layers = [_layer_weights(gen, c, i) for i in range(c["num_hidden_layers"])]
    d, v = c["hidden_size"], c["vocab_size"]
    outer = {"embed": _draw(gen, v, d, scale=0.02),
             "head": _draw(gen, d, v, scale=0.02),
             "final_norm": 1.0 + _draw(gen, d, scale=0.1)}
    tensors = dict(outer)
    nf = c["first_k_dense_replace"]
    for i, w in enumerate(layers):
        prefix = f"first_dense.{i}" if i < nf else f"layers.{i - nf}"
        tensors.update({f"{prefix}.{k}": t for k, t in w.items()})
    return layers, outer, p_lm.LM(port_config(c), tensors)


def _block(w: dict) -> p_lm.Block:
    return p_lm.Block({k[len("moe."):]: t for k, t in w.items()
                       if k.startswith("moe.")})


# --------------------------------------------------------------------------
# the gate
# --------------------------------------------------------------------------

def _loop_gate(scores: np.ndarray, groups: int, topk_groups: int, k: int):
    """The published gate as a plain loop: each group's best score, the
    ``topk_groups`` best groups (ties to the lower group), then the ``k``
    best experts inside them (ties to the lower expert)."""
    n, e = scores.shape
    per = e // groups
    out = []
    for row in scores:
        best = [max(row[g * per:(g + 1) * per]) for g in range(groups)]
        kept = sorted(range(groups), key=lambda g: (-best[g], g))[
            :topk_groups]
        masked = [row[j] if j // per in kept else 0.0 for j in range(e)]
        out.append(sorted(range(e), key=lambda j: (-masked[j], j))[:k])
    return np.array(out)


@pytest.mark.parametrize("ties", [False, True])
def test_gate_matches_a_plain_loop(ties):
    cfg = port_config(TINY)
    gen = torch.Generator().manual_seed(3)
    x = _draw(gen, 40, cfg.d_model)
    router = _draw(gen, cfg.d_model, cfg.router_experts, scale=0.125)
    if ties:
        # repeated router columns and a column that scores every token
        # alike: equal best experts across groups, equal experts in a group
        router[:, 1] = router[:, 0]
        router[:, 6] = router[:, 2]
        router[:, 9] = router[:, 3]
        router[:, 12:16] = 0.0
        x[:8] = 0.0                           # 8 tokens: every score equal
    idx, w = p_moe.route(x, router, cfg)
    scores = torch.softmax(x @ router, -1)
    want = _loop_gate(scores.numpy(), cfg.n_groups, cfg.topk_groups,
                      cfg.top_k)
    assert np.array_equal(idx.numpy(), want)
    torch.testing.assert_close(w, scores.gather(1, idx) * 16.0, rtol=0,
                               atol=0)
    ridx, rw, nties = ref.gate(torch, scores, TINY)
    assert np.array_equal(ridx.numpy(), want) and nties == 0
    torch.testing.assert_close(rw, w, rtol=0, atol=0)
    if ties:
        assert idx[:8].tolist() == [[0, 1, 2]] * 8


def test_reference_takes_the_programs_choice_only_at_near_ties():
    """A program choice within ``TIE_TOL`` of the reference's is taken
    (and counted); one farther off is not."""
    e = TINY["n_routed_experts_published"]
    scores = torch.full((2, e), 0.01)
    scores[:, 0] = 0.05                       # groups 0, 1, 2 best
    scores[:, 2] = 0.04
    scores[:, 4] = 0.03
    scores[:, 5] = 0.02
    scores[0, 1] = 0.02 * (1 - ref.TIE_TOL / 4)  # near-tie with expert 5
    scores[1, 1] = 0.02 * (1 - 4 * ref.TIE_TOL)  # not near
    own, _, _ = ref.gate(torch, scores, TINY)
    assert own.tolist() == [[0, 2, 4], [0, 2, 4]]
    # third place: expert 4 (0.03) well ahead; the tie is for nothing yet:
    # make expert 1 compete with expert 4 instead
    scores[:, 4] = 0.02
    own, _, _ = ref.gate(torch, scores, TINY)
    assert own.tolist() == [[0, 2, 4], [0, 2, 4]]
    program = torch.tensor([[0, 2, 1], [0, 2, 1]])
    got, w, ties = ref.gate(torch, scores, TINY, program)
    assert got.tolist() == [[0, 2, 1], [0, 2, 4]] and ties == 1
    torch.testing.assert_close(w, scores.gather(1, got) * 16.0)


# --------------------------------------------------------------------------
# the expert share
# --------------------------------------------------------------------------

def test_shares_add_up_to_the_whole_layer():
    """The 8 shares of 2 experts each: their held parts plus the shared
    experts once equal the reference's uncut layer (all 16 held); each
    share's counters are the rows routed to its experts."""
    c = dict(TINY, n_routed_experts=16)
    gen = torch.Generator().manual_seed(11)
    w = _moe_weights(gen, c, 16)
    x = _draw(gen, 2, 12, c["hidden_size"])
    whole, idx, _, _ = ref.moe(torch, x.reshape(24, -1), w, c, "float32")
    shared = ref._swiglu(torch, x.reshape(24, -1), w["moe.shared.w_gate"],
                         w["moe.shared.w_up"], w["moe.shared.w_down"],
                         "float32")
    total = shared.clone()
    for s in range(8):
        cfg = port_config(c, n_experts=2, expert_start=2 * s)
        part = {k: (t[2 * s:2 * s + 2] if k in ("moe.w_gate", "moe.w_up",
                                                 "moe.w_down") else t)
                for k, t in w.items()}
        RECORD.start()
        out, aux = p_moe.moe_ffn(_block(part), x, cfg)
        rec = RECORD.stop()
        assert aux == {}
        total += out.reshape(24, -1) - shared
        want = [int((idx == 2 * s + j).sum()) for j in range(2)]
        assert rec["moe.counts"].tolist() == want
        assert torch.equal(rec["moe.routes"], idx)
    torch.testing.assert_close(total, whole, atol=1e-5, rtol=1e-4)


def test_share_is_dropless_where_gshard_would_drop():
    """Every token routed to one held expert: GShard's capacity would keep
    4 of 24 rows; the share computes all 24."""
    c = dict(TINY, n_routed_experts=2)
    cfg = port_config(c, n_experts=2)
    gen = torch.Generator().manual_seed(5)
    w = _moe_weights(gen, c, 2)
    w["moe.router"] = torch.zeros_like(w["moe.router"])
    w["moe.router"][:, 0] = 1.0
    x = _draw(gen, 1, 24, c["hidden_size"]).abs()      # expert 0 first
    RECORD.start()
    got, _ = p_moe.moe_ffn(_block(w), x, cfg)
    assert RECORD.stop()["moe.counts"].tolist() == [24, 24]
    want, _, _, _ = ref.moe(torch, x[0], w, c, "float32")
    torch.testing.assert_close(got[0], want, atol=1e-5, rtol=1e-4)


def test_share_weights_do_not_depend_on_the_other_experts_held():
    cfg = port_config(TINY, n_experts=4, expert_start=4)
    one = p_moe.init_moe(torch.Generator().manual_seed(9), cfg, "cpu")
    two = p_moe.init_moe(torch.Generator().manual_seed(9),
                         dataclasses.replace(cfg, n_experts=2,
                                             expert_start=6), "cpu")
    for k in ("w_gate", "w_up", "w_down"):
        assert torch.equal(one[k][2:], two[k])
    assert torch.equal(one["router"], two["router"])
    assert one["router"].shape == (cfg.d_model, cfg.router_experts)


def test_share_without_groups_or_yarn_takes_a_plain_top_k():
    """An expert share alone, no YaRN: one group of all 16 experts routes
    by the plain softmax top-k; the layer adds each held expert's SwiGLU
    of its rows, weighed by its score."""
    cfg = ExpertShareConfig(
        name="share-tiny", family="moe", n_layers=1, d_model=32, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=64, n_experts=4, top_k=3, moe_d_ff=16,
        router_experts=16, expert_start=8, routed_scale=2.0)
    assert not isinstance(cfg, YarnRopeConfig)
    gen = torch.Generator().manual_seed(21)
    x = _draw(gen, 1, 20, 32)
    w = p_moe.init_moe(gen, cfg, "cpu")
    w["router"] = _draw(gen, 32, 16, scale=0.5)
    idx, gw = p_moe.route(x[0], w["router"], cfg)
    top, want = torch.topk(torch.softmax(x[0] @ w["router"], -1), 3)
    assert torch.equal(idx, want)
    torch.testing.assert_close(gw, top * 2.0, rtol=0, atol=0)
    got, aux = p_moe.moe_ffn(p_lm.Block(w), x, cfg)
    assert aux == {}
    out = torch.zeros(20, 32)
    for t in range(20):
        for e, g in zip(idx[t].tolist(), gw[t].tolist()):
            if 8 <= e < 12:
                j = e - 8
                h = (torch.nn.functional.silu(x[0, t] @ w["w_gate"][j])
                     * (x[0, t] @ w["w_up"][j]))
                out[t] += g * (h @ w["w_down"][j])
    torch.testing.assert_close(got[0], out, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# YaRN and the rope layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("factor", [1.0, 40.0])
def test_rope_layout_and_yarn_switch_on_by_their_own_settings(pairs, factor):
    """``rope_pairs`` alone reorders, a YaRN factor above 1 alone takes
    YaRN's frequencies and softmax scale; a :class:`YarnRopeConfig` with
    neither rotates exactly as a plain MLA config does."""
    from repro_torch.models import attention
    base = dict(name="rope-tiny", family="dense", n_layers=1, d_model=32,
                n_heads=4, n_kv_heads=4, d_ff=64, vocab=64, use_mla=True,
                kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                v_head_dim=16, rope_theta=1e4)
    plain = ModelConfig(**base)
    cfg = YarnRopeConfig(**base, rope_pairs=pairs, yarn_factor=factor,
                         yarn_original_len=64, yarn_mscale=0.707,
                         yarn_mscale_all_dim=0.707)
    x = _draw(torch.Generator().manual_seed(6), 2, 5, 3, 8)
    pos = torch.tensor([[0, 3, 70, 900, 4095]] * 2, dtype=torch.int32)
    want = p_layers.pairs_to_halves(x) if pairs else x
    if factor > 1:
        freqs = p_layers.yarn_frequencies(8, 1e4, factor, 64, 32.0, 1.0)
        want = p_layers.apply_rope_freqs(want, pos, freqs, 1.0)
        assert attention._yarn_on(cfg)
    else:
        want = p_layers.apply_rope(want, pos, 1e4)
        assert not attention._yarn_on(cfg)
    assert torch.equal(attention._mla_rope(x, pos, cfg), want)
    if not pairs and factor == 1:
        assert torch.equal(attention._mla_rope(x, pos, plain), want)
    assert not attention._yarn_on(plain)


def test_yarn_frequencies_and_mscale_match_their_formulas():
    """The published values: 64 rotary dims, theta 1e4, factor 40 over
    4096 positions, beta_fast 32 / beta_slow 1: the ramp runs from
    dimension 10 to 23."""
    dim, theta, factor, orig = 64, 1e4, 40.0, 4096
    low = math.floor(dim * math.log(orig / (32 * 2 * math.pi))
                     / (2 * math.log(theta)))
    high = math.ceil(dim * math.log(orig / (1 * 2 * math.pi))
                     / (2 * math.log(theta)))
    assert (low, high) == (10, 23)
    want = []
    for j in range(dim // 2):
        base = theta ** (-2 * j / dim)
        ramp = min(max((j - low) / (high - low), 0.0), 1.0)
        want.append(base / factor * ramp + base * (1 - ramp))
    got = p_layers.yarn_frequencies(dim, theta, factor, orig, 32.0, 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    cfg = dict(TINY, qk_rope_head_dim=64,
               rope_scaling=dict(TINY["rope_scaling"],
                                 original_max_position_embeddings=4096))
    assert torch.equal(ref.yarn_inv_freq(torch, cfg, "cpu"), got)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(m - 1.26080) < 1e-5
    assert yarn_mscale(40, 0.707) == pytest.approx(m, rel=1e-15)
    pc = port_config(TINY, qk_nope_dim=128, qk_rope_dim=64)
    assert pc.mla_softmax_scale == pytest.approx(m * m / math.sqrt(192),
                                                 rel=1e-15)
    assert ref.softmax_scale(dict(TINY, qk_nope_head_dim=128,
                                  qk_rope_head_dim=64)) == \
        pytest.approx(m * m / math.sqrt(192), rel=1e-15)


def test_interleaved_rope_reorders_pairs_then_rotates_halves():
    """q_pe in (even, odd) pairs: reordered to halves, then rotated; at
    position 0 the rotation is the identity."""
    cfg = port_config(TINY)
    x = torch.arange(2 * 8, dtype=torch.float32).reshape(1, 1, 2, 8)
    halves = p_layers.pairs_to_halves(x)
    assert halves[0, 0, 0].tolist() == [0, 2, 4, 6, 1, 3, 5, 7]
    from repro_torch.models.attention import _mla_rope
    pos = torch.zeros((1, 1), dtype=torch.int32)
    assert torch.equal(_mla_rope(x, pos, cfg), halves)
    gen = torch.Generator().manual_seed(2)
    y = _draw(gen, 2, 5, 3, 8)
    pos = torch.tensor([[0, 3, 70, 900, 4095]] * 2, dtype=torch.int32)
    torch.testing.assert_close(
        _mla_rope(y, pos, cfg), ref.rope(torch, y, pos[0], TINY),
        rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# prefill and decode through the engine
# --------------------------------------------------------------------------

def test_engine_prefill_and_decode_match_the_reference():
    """Prefill of 7 positions and 5 greedy steps through
    ``DecodeEngine.decode_step`` (absorbed MLA over the latent cache, the
    expert share of 6 of the 16 experts), against the reference's full
    forward over the same tokens: the logits of every step and every
    latent and rope-key row."""
    c = dict(TINY, n_routed_experts=6, expert_start=4)
    layers, outer, params = _model(c, seed=1)
    cfg = params.cfg
    b, prompt, gen_steps = 2, 7, 5
    engine = DecodeEngine(cfg, max_batch=b, prompt_len=prompt,
                          max_gen=gen_steps, attention_impl="registry",
                          params=params, device="cpu")
    toks = torch.randint(0, c["vocab_size"], (b, prompt),
                         generator=torch.Generator().manual_seed(4))
    RECORD.start()
    logits, caches = engine.prefill({"tokens": toks})
    fed, got = [toks], [logits[:, -1]]
    tok = logits[:, -1].argmax(-1)[:, None]
    for j in range(gen_steps):
        fed.append(tok)
        logits, caches = engine.decode_step(tok, caches, prompt + j)
        got.append(logits[:, 0])
        tok = logits[:, 0].argmax(-1)[:, None]
    rec = RECORD.stop()
    tokens = torch.cat(fed, 1)                               # (B, T)
    t = tokens.shape[1]
    moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    # the program's routes per MoE layer as (B, T, k): the prefill's call
    # (B * prompt rows), then one call per step (B rows)
    routes = rec["moe.routes"]
    n_pre = moe_layers * b * prompt
    pre = routes[:n_pre].reshape(moe_layers, b, prompt, -1)
    steps = routes[n_pre:].reshape(gen_steps, moe_layers, b, -1)
    prog = torch.cat([pre, steps.permute(1, 2, 0, 3)], 2)

    def no_history(i):
        return (torch.zeros(b, 0, c["kv_lora_rank"]),
                torch.zeros(b, 0, c["qk_rope_head_dim"]))
    out = ref.forward(torch, c, lambda i: layers[i], outer, tokens, 0,
                      no_history,
                      program_routes=lambda i: prog[i - 1])
    assert out.ties == [0] * moe_layers
    for i in range(moe_layers):
        assert torch.equal(out.routes[i], prog[i])
    want = ref.logits(torch, out.hidden, outer["head"])
    for j, lg in enumerate(got):
        torch.testing.assert_close(lg, want[:, prompt - 1 + j], atol=2e-5,
                                   rtol=1e-4)
    nf = c["first_k_dense_replace"]
    for i in range(c["num_hidden_layers"]):
        grp, k = ("first_dense", i) if i < nf else ("attn", i - nf)
        torch.testing.assert_close(caches[grp]["latent"][k, :, :t],
                                   out.latent[i], atol=2e-5, rtol=1e-4)
        torch.testing.assert_close(caches[grp]["k_rope"][k, :, :t],
                                   out.k_rope[i], atol=2e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# the GShard path is what it was
# --------------------------------------------------------------------------

def _gshard_formula(p, x, cfg, group_size=2048):
    """The GShard MoE as the port computed it before the expert share
    (frozen here): capacity buffers scattered by index, every expert's
    einsums, gathered back by their gates, the shared experts added."""
    import torch.nn.functional as F
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    sg = min(group_size, t)
    while t % sg:
        sg //= 2
    g = t // sg
    cap = max(int(sg * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 4)
    xt = x.reshape(g, sg, d)
    probs = torch.softmax((xt @ p.router).float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    onehot = F.one_hot(idx, e)
    slot_flat = onehot.reshape(g, sg * k, e)
    pos = ((torch.cumsum(slot_flat, dim=1) - 1) * slot_flat).sum(-1)
    pos = pos.reshape(g, sg, k)
    keep = pos < cap
    gate_vals = gate_vals * keep.float()
    n = g * e * cap
    gi = torch.arange(g)[:, None, None]
    flat = (gi * e + idx) * cap + torch.clamp_max(pos, cap - 1)
    xe = torch.zeros((n + 1, d), dtype=x.dtype)
    xe[torch.where(keep, flat, n).reshape(-1)] = \
        xt[:, :, None, :].expand(g, sg, k, d).reshape(-1, d)
    xe = xe[:n].reshape(g, e, cap, d)
    gt = torch.einsum("gecd,edf->gecf", xe, p.w_gate)
    u = torch.einsum("gecd,edf->gecf", xe, p.w_up)
    y = torch.einsum("gecf,efd->gecd", F.silu(gt) * u, p.w_down)
    out = (y.reshape(-1, d)[flat] * gate_vals.to(y.dtype)[..., None]).sum(2)
    out = out.reshape(g * sg, d)
    if "shared" in p:
        xs = xt.reshape(g * sg, d)
        sp = p.shared
        out = out + (F.silu(xs @ sp.w_gate) * (xs @ sp.w_up)) @ sp.w_down
    return out.reshape(x.shape)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_gshard_path_is_bit_equal_to_its_formula(name, capacity_factor):
    cfg = dataclasses.replace(p_configs.reduced(p_configs.get_arch(name)),
                              capacity_factor=capacity_factor)
    assert not isinstance(cfg, (ExpertShareConfig, YarnRopeConfig))
    w = p_moe.init_moe(torch.Generator().manual_seed(8), cfg, "cpu")
    p = p_lm.Block(w)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(9))
    got, _ = p_moe.moe_ffn(p, x, cfg)
    assert torch.equal(got, _gshard_formula(p, x, cfg))


# --------------------------------------------------------------------------
# on the card: the expert kernel against its plain version, and a decode
# step that never waits for the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


#: (held experts, d, f, rows routed to each): the cell's widths with the
#: routing a decode step sees, an expert with more rows than a pass takes,
#: untouched experts, every row on one expert; and small odd widths.
EXPERT_CASES = [
    (20, 5120, 1536, [0, 1, 2, 3, 9, 17, 0, 5, 2, 2, 3, 1, 0, 4, 2, 2, 3,
                      1, 2, 1]),
    (20, 5120, 1536, [64] + [0] * 19),
    (3, 200, 72, [0, 0, 0]),
    (3, 200, 72, [1, 8, 9]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,f,counts", EXPERT_CASES)
def test_card_expert_kernel_matches_plain(card, n, d, f, counts):
    from repro_torch.kernels import _ext
    from repro_torch.kernels.experts import (grouped_swiglu,
                                             grouped_swiglu_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=card).manual_seed(0)
    wg = torch.randn(n, d, f, generator=gen, device=card) / d ** 0.5
    wu = torch.randn(n, d, f, generator=gen, device=card) / d ** 0.5
    wd = torch.randn(n, f, d, generator=gen, device=card) / f ** 0.5
    offsets = torch.tensor([0] + counts, device=card).cumsum(0).to(
        torch.int32)
    xs = torch.randn(sum(counts) + 5, d, generator=gen, device=card)
    before = _ext.LAUNCHES["experts"]
    got = grouped_swiglu(xs, offsets, wg, wu, wd)
    want = grouped_swiglu_plain(xs, offsets, wg, wu, wd)
    torch.cuda.synchronize()
    m = sum(counts)
    assert _ext.LAUNCHES["experts"] == before + 1
    if m:
        torch.testing.assert_close(got[:m], want[:m], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_card_share_decode_step_waits_for_nothing(card):
    """A decode step of the tiny model on the card (the expert kernel,
    absorbed MLA with YaRN) issues no host synchronisation, and agrees
    with the same step on the CPU."""
    c = dict(TINY, n_routed_experts=6, expert_start=4)
    layers, outer, params = _model(c, seed=1)
    b, prompt = 2, 7
    tensors = params.state_dict()
    engines = {dev: DecodeEngine(
        params.cfg, max_batch=b, prompt_len=prompt, max_gen=4, device=dev,
        params=p_lm.LM(params.cfg, {k: v.to(dev) for k, v in
                                    tensors.items()}))
        for dev in ("cpu", card)}
    toks = torch.randint(0, c["vocab_size"], (b, prompt),
                         generator=torch.Generator().manual_seed(4))
    out = {}
    for dev, eng in engines.items():
        logits, caches = eng.prefill({"tokens": toks.to(dev)})
        tok = logits[:, -1].argmax(-1)[:, None]
        eng.decode_step(tok, caches, prompt)                # warm
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = eng.decode_step(tok, caches, prompt + 1)
        finally:
            if dev != "cpu":
                torch.cuda.set_sync_debug_mode(0)
        out[dev] = logits.cpu()
    torch.testing.assert_close(out[card], out["cpu"], atol=2e-5, rtol=1e-4)
