"""Offline batched greedy decode of DeepSeek-V2 (an expert share of it):
one closed-loop batch of sequences against a long history, through the
port's ``DecodeEngine.decode_step`` with its MLA cache.

The traffic is ``decode_closed``'s: set-up makes the weights and each
layer's history on the device from the seed, writes the history straight
into the port's latent cache (each layer's latent rows after ``kv_norm``
and its rope-key rows, rotated: positions ``0 .. history - 1``), warms
up every shape and then for ``warmup_s`` seconds (in a traced run, then
times the host's own cost of a step on an idle card) and rewinds.  The
window decodes from position ``history``; each step feeds every sequence its last token and takes the
argmax as the next, with a CUDA event after it and no wait for the card;
a full cache rewinds to ``history`` (a new request over the same
document).  While the window runs, the port's device record
(``repro_torch.obs.record``) keeps each MoE layer's rows routed to each
held expert, each token's experts and their weights; they come to the
host once, after the window's synchronisation.

Each routed expert's weights come from a stream of their own, by (layer,
expert id), so a share's weights do not depend on which experts it
holds.

The check regenerates the weights and the history, runs the reference
(``reference.deepseek_v2``) over the current request's tokens (its
first from the seed, the rest the tokens the program served) and
compares: each served token's reference logit below the reference's best
(``logit_gap``, every step), the logits of a sample of steps drawn from
the seed (``logits_err``), the latent and rope-key rows the window wrote
into every layer (``latent_err``), and the rows routed to each held
expert in every MoE layer and step against the reference's routing of
the same tokens (``routing_err``: the summed count differences over the
reference's summed counts).  The reference takes the program's routing
only at near-ties (``reference.deepseek_v2.gate``), and ``tie_share``
holds how often it did, per token and MoE layer, to a limit of its own:
a router off by more than rounding moves more choices into that band.
The check logs the near-ties and the largest relative difference of the
two sides' weights of the same experts.
"""
from __future__ import annotations

import math
import time

from perfbench.harness import core, inputs
from perfbench.reference import deepseek_v2 as ref

_CLOSED = core.driver("decode_closed")
_rel = _CLOSED._rel
_host_probe = _CLOSED._host_probe


def model_config(cfg: dict):
    """The port's ``DeepSeekV2Config`` for a configuration file's sizes."""
    from repro_torch.models.config import DeepSeekV2Config
    rs = cfg["rope_scaling"]
    return DeepSeekV2Config(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], use_mla=True,
        kv_lora_rank=cfg["kv_lora_rank"], q_lora_rank=cfg["q_lora_rank"],
        qk_nope_dim=cfg["qk_nope_head_dim"],
        qk_rope_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        n_experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"],
        moe_d_ff=cfg["moe_intermediate_size"],
        first_dense_layers=cfg["first_k_dense_replace"],
        dense_d_ff=cfg["intermediate_size"],
        router_experts=cfg["n_routed_experts_published"],
        expert_start=cfg["expert_start"], n_groups=cfg["n_group"],
        topk_groups=cfg["topk_group"],
        routed_scale=float(cfg["routed_scaling_factor"]),
        yarn_factor=float(rs["factor"]),
        yarn_original_len=rs["original_max_position_embeddings"],
        yarn_beta_fast=float(rs["beta_fast"]),
        yarn_beta_slow=float(rs["beta_slow"]),
        yarn_mscale=float(rs["mscale"]),
        yarn_mscale_all_dim=float(rs["mscale_all_dim"]))


def _layer_shapes(cfg: dict, layer: int):
    """(name, shape, d_in) of layer ``layer``'s matrices drawn in its one
    draw (the routed experts apart), in order; d_in 0 marks a norm."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qr, r = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rd, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    out = [("ln1", (d,), 0), ("ln2", (d,), 0),
           ("attn.wq_a", (d, qr), d), ("attn.q_norm", (qr,), 0),
           ("attn.wq_b", (qr, h * (nope + rd)), qr),
           ("attn.wkv_a", (d, r + rd), d), ("attn.kv_norm", (r,), 0),
           ("attn.wkv_b", (r, h * (nope + vd)), r),
           ("attn.wo", (h * vd, d), h * vd)]
    if layer < cfg["first_k_dense_replace"]:
        f = cfg["intermediate_size"]
        return out + [("mlp.w_gate", (d, f), d), ("mlp.w_up", (d, f), d),
                      ("mlp.w_down", (f, d), f)]
    fs = cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    return out + [("moe.router", (d, cfg["n_routed_experts_published"]), d),
                  ("moe.shared.w_gate", (d, fs), d),
                  ("moe.shared.w_up", (d, fs), d),
                  ("moe.shared.w_down", (fs, d), fs)]


def layer_weights(torch, cfg: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer``'s weights as the reference names them: one draw for
    all but the routed experts (matrices N(0, 1/d_in), norms 1 + N(0,
    0.1^2)), and each held routed expert's three matrices from a stream
    of its own, (layer, expert id), stacked as ``moe.w_gate`` (n, d, f),
    ``moe.w_up`` and ``moe.w_down`` (n, f, d)."""
    shapes = _layer_shapes(cfg, layer)
    g = core.generator(torch, device, seed, "layer", layer)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in shapes),
                       generator=g, device=device)
    out, off = {}, 0
    for name, shape, d_in in shapes:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        out[name] = (t.mul_(0.1).add_(1.0) if d_in == 0
                     else t.mul_(1.0 / math.sqrt(d_in)))
        off += n
    if layer >= cfg["first_k_dense_replace"]:
        d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
        n = cfg["n_routed_experts"]
        stacks = {"moe.w_gate": (n, d, f), "moe.w_up": (n, d, f),
                  "moe.w_down": (n, f, d)}
        for name, shape in stacks.items():
            out[name] = torch.empty(shape, device=device)
        for j in range(n):
            e = cfg["expert_start"] + j
            ge = core.generator(torch, device, seed, "expert", layer, e)
            for name in stacks:
                w = out[name][j]
                torch.randn(w.shape, generator=ge, device=device, out=w)
                w.mul_(1.0 / math.sqrt(w.shape[0]))
    return out


def history(torch, cfg: dict, wl: dict, seed: int, layer: int, device):
    """Layer ``layer``'s latent rows (batch, history, kv_lora) and rope-key
    rows (batch, history, rope dims) of the decode history, N(0, 1): as
    the cache holds them (after ``kv_norm``; rotated)."""
    b, s = wl["batch"], wl["history"]
    return tuple(torch.randn(
        (b, s, cfg[k]), generator=core.generator(
            torch, device, seed, "history", layer, k), device=device)
        for k in ("kv_lora_rank", "qk_rope_head_dim"))


def _port_tensors(torch, cfg: dict, seed: int, device) -> dict:
    """The port's ``state_dict`` names for every weight."""
    t = dict(inputs.dense_outer(torch, cfg, seed, device))
    nf = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        prefix = f"first_dense.{i}" if i < nf else f"layers.{i - nf}"
        t.update({f"{prefix}.{k}": v for k, v in
                  layer_weights(torch, cfg, seed, i, device).items()})
    return t


def _layer_caches(caches, cfg: dict, i: int):
    """(latent, rope key) caches of layer i (B, S, r) / (B, S, rd)."""
    nf = cfg["first_k_dense_replace"]
    grp, k = ("first_dense", i) if i < nf else ("attn", i - nf)
    return caches[grp]["latent"][k], caches[grp]["k_rope"][k]


def setup(ctx):
    """Weights, the program's engine and cache, the history, warm-up."""
    torch = ctx.torch
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    dtype = getattr(torch, core.stated_dtype(cfg))
    mcfg = model_config(cfg)
    from repro_torch.models import lm
    from repro_torch.models.engine import DecodeEngine
    if ctx.backend == "cuda":
        core.build_kernels(ctx)
    t0 = time.perf_counter()
    params = lm.LM(mcfg, _port_tensors(torch, cfg, ctx.seed, dev))
    cache_len, hist = wl["cache_len"], wl["history"]
    engine = DecodeEngine(mcfg, max_batch=wl["batch"], prompt_len=hist,
                          max_gen=cache_len - hist, dtype=dtype,
                          attention_impl="registry", params=params,
                          device=dev)
    caches = lm.init_caches(engine.cfg, wl["batch"], cache_len,
                            dtype=dtype, device=dev)
    for i in range(cfg["num_hidden_layers"]):
        lat, kr = _layer_caches(caches, cfg, i)
        hc, hkr = history(torch, cfg, wl, ctx.seed, i, dev)
        lat[:, :hist].copy_(hc)
        kr[:, :hist].copy_(hkr)
        del hc, hkr
    first = inputs.request_tokens(torch, cfg, wl, ctx.seed, 0, dev)
    tok = inputs.request_tokens(torch, cfg, wl, ctx.seed, "warm", dev)
    ctx.sync()
    t = time.perf_counter()
    # every shape, then steps until ``warmup_s`` have passed: the step is
    # compute-bound at the card's power limit, and its clock settles as
    # the card warms; the rows written here are rewritten by the window
    # before it reads them
    j = 0
    while hist + j < cache_len and (j < wl["warmup_steps"] or
                                    time.perf_counter() - t < wl["warmup_s"]):
        logits, caches = engine.decode_step(tok, caches, hist + j)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        j += 1
    ctx.sync()
    ctx.log(f"setup: weights, cache and history {t - t0:.2f} s, warm-up "
            f"{time.perf_counter() - t:.2f} s")
    host_ms = []
    if ctx.tracer.enabled:
        host_ms, caches = _host_probe(ctx, engine, caches, tok, hist)
    return {"engine": engine, "caches": caches, "first": first,
            "host_ms": host_ms}


def window(ctx, state):
    """The timed loop (module docstring)."""
    torch = ctx.torch
    cfg, wl = ctx.config, ctx.workload
    engine, caches = state["engine"], state["caches"]
    from repro_torch.obs.record import RECORD
    hist, cache_len, b = wl["history"], wl["cache_len"], wl["batch"]
    stride = wl["logit_stride"]
    offset = core.subseed(ctx.seed, "logit_offset") % stride
    cuda = ctx.backend == "cuda"
    core.reset_launches()
    events = ([torch.cuda.Event(enable_timing=True)
               for _ in range(wl["events"])] if cuda else [])
    pos, req, tok = hist, 0, state["first"]
    fed, kept, kv_lens, prev = [], {}, [], None
    steps = pre_steps = 0
    pre_s = None
    ctx.sync()
    RECORD.start()
    t0 = time.perf_counter()
    if cuda:
        start_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds and not ctx.tracer.open:
            break
        was_open = ctx.tracer.open
        ctx.tracer.tick(elapsed)
        if ctx.tracer.open and not was_open:
            pre_s, pre_steps = ctx.tracer.opened_at - t0, steps
        with ctx.tracer.range("pb.step"):
            logits, caches = engine.decode_step(tok, caches, pos)
            nxt = torch.argmax(logits[:, 0], dim=-1)[:, None]
        if cuda:
            if steps == len(events):
                events.append(torch.cuda.Event(enable_timing=True))
            events[steps].record()
        kv_lens.append(pos + 1)
        fed.append(tok)
        if (pos - hist) % stride == offset:
            kept[pos - hist] = logits[:, 0]
        tok = nxt
        pos += 1
        steps += 1
        if pos == cache_len:
            req += 1
            ctx.log(f"request: the cache is full after step {steps}; the "
                    f"position rewinds to {hist} for request {req}")
            prev = (fed, kept, tok)
            fed, kept = [], {}
            pos = hist
            tok = inputs.request_tokens(torch, cfg, wl, ctx.seed, req,
                                        ctx.device)
    ctx.sync()
    seconds = time.perf_counter() - t0
    rec = RECORD.stop()
    itl = []
    if cuda:
        before = start_ev
        for ev in events[:steps]:
            itl.append(before.elapsed_time(ev))
            before = ev
    if pre_s is None:
        pre_s, pre_steps = seconds, steps
    if itl:
        ctx.log(f"window: {steps} steps in {seconds:.3f} s; step gaps ms: "
                f"median {core.percentile(itl, 50):.3f}, p95 "
                f"{core.percentile(itl, 95):.3f}, max {max(itl):.3f}")
    ctx.log(f"launches: {core.launches()}")
    if not fed:
        fed, kept, tok = prev
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    n = cfg["n_routed_experts"]
    counts = rec["moe.counts"].reshape(steps, layers, n)
    return {"seconds": seconds, "steps": steps, "batch": b,
            "attempted": steps * b, "itl_ms": itl,
            "host_ms": state.pop("host_ms"),
            "kv_lens": kv_lens, "pre_seconds": pre_s, "pre_steps": pre_steps,
            "request": req, "fed": fed, "last": tok, "kept": kept,
            "moe_touched": (counts > 0).sum((1, 2)).tolist(),
            "moe_rows": counts.sum((1, 2)).tolist(),
            "moe_counts": counts,
            "moe_routes": rec["moe.routes"].reshape(steps, layers, b, -1),
            "moe_gates": rec["moe.gates"].reshape(steps, layers, b, -1)}


def _counts(torch, routes, start: int, n: int):
    """Rows routed to each held expert: (T, n) of routes (B, T, k)."""
    ids = torch.arange(start, start + n, device=routes.device)
    return (routes[..., None] == ids).sum((0, 2))


def check(ctx, state, record, control: bool = False):
    """Frees the program's state, runs the reference over the current
    request (the finished one, where the window closed on a rewind) and
    returns ``logit_gap``, ``logits_err``, ``latent_err``, ``routing_err``
    and ``tie_share``; with ``control``, the reference computed in TF32
    stands in for the program."""
    torch = ctx.torch
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    hist, nf = wl["history"], cfg["first_k_dense_replace"]
    fed, kept = record.pop("fed"), record.pop("kept")
    t = len(fed)
    tokens = torch.cat(fed, dim=1)                           # (B, T)
    served = torch.cat(fed[1:] + [record.pop("last")], dim=1)
    # the request's steps are the window's last t; per MoE layer (B, T, k)
    counts = record.pop("moe_counts")[-t:].to(dev)           # (T, L, n)
    routes = record.pop("moe_routes")[-t:].permute(1, 2, 0, 3).to(dev)
    gates = record.pop("moe_gates")[-t:].permute(1, 2, 0, 3).to(dev)
    caches = state.pop("caches")
    rows = [tuple(c[:, hist:hist + t].clone()
                  for c in _layer_caches(caches, cfg, i))
            for i in range(cfg["num_hidden_layers"])]
    state.clear()
    del caches
    core.free(ctx)
    t_ref = time.perf_counter()
    outer = inputs.dense_outer(torch, cfg, ctx.seed, dev)

    def layer_fn(i):
        return layer_weights(torch, cfg, ctx.seed, i, dev)

    def history_fn(i):
        return history(torch, cfg, wl, ctx.seed, i, dev)
    with torch.no_grad():
        alt = None
        if control:
            alt = ref.forward(torch, cfg, layer_fn, outer, tokens, hist,
                              history_fn, precision="tf32")
            routes, gates = alt.routes, alt.gates
            counts = torch.stack([_counts(torch, r, cfg["expert_start"],
                                          cfg["n_routed_experts"])
                                  for r in routes], 1)
            rows = list(zip(alt.latent, alt.k_rope))
        out = ref.forward(torch, cfg, layer_fn, outer, tokens, hist,
                          history_fn, program_routes=lambda i: routes[i - nf])
        nums = _compare(ctx, outer, out, alt, rows, served, kept)
    ref_counts = torch.stack([_counts(torch, r, cfg["expert_start"],
                                      cfg["n_routed_experts"])
                              for r in out.routes], 1)       # (T, L, n)
    nums["routing_err"] = float((counts - ref_counts).abs().sum()) / max(
        1.0, float(ref_counts.sum()))
    nums["tie_share"] = sum(out.ties) / (tokens.numel() * len(out.ties))
    same = [(a == b).all(-1) for a, b in zip(routes, out.routes)]
    diff = max((float(((g - r).abs() / r.abs().clamp_min(1e-30))[s].max())
                for g, r, s in zip(gates, out.gates, same) if s.any()),
               default=0.0)
    record["route_ties"] = out.ties
    record["gate_rel_diff"] = diff
    ctx.log(f"reference: {t} steps of {wl['batch']} sequences in "
            f"{time.perf_counter() - t_ref:.1f} s; routing near-ties taken "
            f"from the {'control' if control else 'program'} per MoE "
            f"layer {out.ties}; largest relative gate difference where the "
            f"routes agree {diff:.3e}")
    return nums


def _compare(ctx, outer, out, alt, rows, served, kept):
    """``logit_gap``, ``logits_err`` and ``latent_err`` (module
    docstring); with ``alt`` (the control) its logits and tokens stand in
    for the program's."""
    torch = ctx.torch
    t = out.hidden.shape[1]
    latent_err = 0.0
    for (pl, pk), rl, rk in zip(rows, out.latent, out.k_rope):
        latent_err = max(latent_err, _rel(torch, pl, rl), _rel(torch, pk, rk))
    gap, lerr = 0.0, 0.0
    block = ctx.workload["check_block"]
    for s0 in range(0, t, block):
        s1 = min(t, s0 + block)
        lr = ref.logits(torch, out.hidden[:, s0:s1], outer["head"])
        if alt is not None:
            la = ref.logits(torch, alt.hidden[:, s0:s1], outer["head"],
                            precision="tf32")
            pick = la.argmax(-1, keepdim=True)
            lerr = max(lerr, _rel(torch, la, lr))
        else:
            pick = served[:, s0:s1, None]
            for j in range(s0, s1):
                if j in kept:
                    lerr = max(lerr, _rel(torch, kept[j], lr[:, j - s0]))
        best = lr.amax(-1, keepdim=True)
        gap = max(gap, float((best - lr.gather(-1, pick)).max()))
        del lr
    return {"logit_gap": gap, "logits_err": lerr, "latent_err": latent_err}
