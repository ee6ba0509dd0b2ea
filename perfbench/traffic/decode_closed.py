"""Offline batched greedy decode: one closed-loop batch of sequences
against a long history, through the port's ``DecodeEngine.decode_step``.

Set-up makes the weights and each layer's history on the device from the
seed, writes the history straight into the port's KV cache (positions
``0 .. history - 1``: each session's long document), warms up a few
steps (in a traced run, then times the host's own cost of a step on an
idle card) and rewinds.  The window then decodes from position ``history``:
each step feeds every sequence its last token, takes the argmax of the
logits as the next one, and records a CUDA event, without waiting for
the card.  When the cache is full the position rewinds to ``history``: a
new request over the same document (logged; no rate the card can reach
gets there inside a window of the allowed length).

The check regenerates the weights and the history, runs the reference
over the current request's tokens (its first from the seed, the rest the
tokens the program served) and compares: the gap by which each served
token's reference logit lies below the reference's best (every step),
the logits of a sample of steps drawn from the seed, and the K / V rows
the window wrote into every layer.
"""
from __future__ import annotations

import contextlib
import time

from perfbench.costs import decode as decode_costs
from perfbench.costs import kernels as kernel_costs
from perfbench.harness import core, inputs
from perfbench.reference import dense_lm

#: Steps in the host probe of a traced run (``_host_probe``).
HOST_PROBE_STEPS = 16


def model_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file's sizes."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"])


def _weights(torch, cfg, seed, device):
    t = {}
    for i in range(cfg["num_hidden_layers"]):
        t.update({f"layers.{i}.{k}": v for k, v in inputs.dense_layer(
            torch, cfg, seed, i, device).items()})
    t.update(inputs.dense_outer(torch, cfg, seed, device))
    return t


def setup(ctx):
    """Weights, the program's engine and cache, the history, warm-up."""
    torch = ctx.torch
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    dtype = getattr(torch, core.stated_dtype(cfg))
    from repro_torch.models import lm
    from repro_torch.models.engine import DecodeEngine
    if ctx.backend == "cuda":
        core.build_kernels(ctx)
    t0 = time.perf_counter()
    mcfg = model_config(cfg)
    params = lm.LM(mcfg, _weights(torch, cfg, ctx.seed, dev))
    cache_len, hist = wl["cache_len"], wl["history"]
    engine = DecodeEngine(mcfg, max_batch=wl["batch"], prompt_len=hist,
                          max_gen=cache_len - hist, dtype=dtype,
                          engine=wl["engine"], attention_impl="registry",
                          params=params, device=dev)
    caches = lm.init_caches(engine.cfg, wl["batch"], cache_len,
                            dtype=dtype, device=dev)
    for i in range(cfg["num_hidden_layers"]):
        hk, hv = inputs.history(torch, cfg, wl, ctx.seed, i, dev)
        caches["attn"]["k"][i, :, :hist].copy_(hk)
        caches["attn"]["v"][i, :, :hist].copy_(hv)
        del hk, hv
    first = inputs.request_tokens(torch, cfg, wl, ctx.seed, 0, dev)
    tok = inputs.request_tokens(torch, cfg, wl, ctx.seed, "warm", dev)
    ctx.sync()
    t = time.perf_counter()
    for j in range(wl["warmup_steps"]):
        logits, caches = engine.decode_step(tok, caches, hist + j)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
    ctx.sync()
    ctx.log(f"setup: weights, cache and history {t - t0:.2f} s, warm-up "
            f"{time.perf_counter() - t:.2f} s")
    host_ms = []
    if ctx.tracer.enabled:
        host_ms, caches = _host_probe(ctx, engine, caches, tok, hist)
    return {"engine": engine, "caches": caches, "first": first,
            "host_ms": host_ms}


def _host_probe(ctx, engine, caches, tok, pos):
    """The host's own milliseconds per step: ``HOST_PROBE_STEPS`` steps,
    each issued onto an idle card (a synchronisation before it) and timed
    from the call to the return of its argmax, so that no launch waits in
    a full queue.  They write rows the window overwrites before it reads
    them.  Logs, beside them, each step's time to the card's finish."""
    torch = ctx.torch
    host, done = [], []
    n = min(HOST_PROBE_STEPS, ctx.workload["cache_len"] - pos)
    for j in range(n):
        ctx.sync()
        h0 = time.perf_counter()
        logits, caches = engine.decode_step(tok, caches, pos + j)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        host.append((time.perf_counter() - h0) * 1e3)
        ctx.sync()
        done.append((time.perf_counter() - h0) * 1e3)
    ctx.log(f"host probe: {len(host)} steps onto an idle card, host ms "
            f"median {core.percentile(host, 50):.3f}, to the card's finish "
            f"median {core.percentile(done, 50):.3f}")
    return host, caches


def _k4_probe(ctx, ext):
    """While the sub-window is profiled: each flash-decode launch inside a
    ``pb.k4`` range, with the bytes and operations of its call (none where
    the port launches K4 otherwise: the metric then stays silent)."""
    original = getattr(ext, "attention", None)
    if original is None:
        return contextlib.nullcontext()

    def traced(q, k, v, kv_len, **kw):
        b, kh, g, dh = q.shape
        work = kernel_costs.flash_decode(b, kh, g, dh, k.shape[1],
                                         int(kv_len), k.element_size())
        with ctx.tracer.range("pb.k4", work=work):
            return original(q, k, v, kv_len, **kw)

    @contextlib.contextmanager
    def installed():
        ext.attention = traced
        try:
            yield
        finally:
            ext.attention = original
    return installed()


def window(ctx, state):
    """The timed loop (module docstring)."""
    torch = ctx.torch
    cfg, wl = ctx.config, ctx.workload
    engine, caches = state["engine"], state["caches"]
    from repro_torch.kernels import _ext
    hist, cache_len, b = wl["history"], wl["cache_len"], wl["batch"]
    stride = wl["logit_stride"]
    offset = core.subseed(ctx.seed, "logit_offset") % stride
    cuda = ctx.backend == "cuda"
    if ctx.tracer.enabled:
        ctx.tracer.hooks.append(_k4_probe(ctx, _ext))
    core.reset_launches()
    events = ([torch.cuda.Event(enable_timing=True)
               for _ in range(wl["events"])] if cuda else [])
    pos, req, tok = hist, 0, state["first"]
    fed, kept, kv_lens, prev = [], {}, [], None
    steps = pre_steps = 0
    pre_s = None
    ctx.sync()
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
        work = decode_costs.step(cfg, b, pos + 1) if ctx.tracer.open \
            else None
        with ctx.tracer.range("pb.step", work=work):
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
            # the finished request stays checkable until a step of the
            # next one overwrites its rows
            prev = (fed, kept, tok)
            fed, kept = [], {}
            pos = hist
            tok = inputs.request_tokens(torch, cfg, wl, ctx.seed, req,
                                        ctx.device)
    ctx.sync()
    seconds = time.perf_counter() - t0
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
    return {"seconds": seconds, "steps": steps, "batch": b,
            "attempted": steps * b, "itl_ms": itl,
            "host_ms": state.pop("host_ms"),
            "kv_lens": kv_lens, "pre_seconds": pre_s, "pre_steps": pre_steps,
            "request": req, "fed": fed, "last": tok, "kept": kept}


def check(ctx, state, record, control: bool = False):
    """Frees the program's state, runs the reference over the current
    request (the finished one, where the window closed on a rewind) and
    returns ``logit_gap``, ``logits_err`` and ``kv_err``."""
    torch = ctx.torch
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    hist = wl["history"]
    fed, kept = record.pop("fed"), record.pop("kept")
    t = len(fed)
    tokens = torch.cat(fed, dim=1)                           # (B, T)
    served = torch.cat(fed[1:] + [record.pop("last")], dim=1)
    caches = state.pop("caches")
    rows = [(caches["attn"]["k"][i, :, hist:hist + t].clone(),
             caches["attn"]["v"][i, :, hist:hist + t].clone())
            for i in range(cfg["num_hidden_layers"])]
    state.clear()
    del caches
    core.free(ctx)
    t_ref = time.perf_counter()
    outer = inputs.dense_outer(torch, cfg, ctx.seed, dev)

    def layer_fn(i):
        return inputs.dense_layer(torch, cfg, ctx.seed, i, dev)

    def history_fn(i):
        return inputs.history(torch, cfg, wl, ctx.seed, i, dev)
    with torch.no_grad():
        ref = dense_lm.forward(torch, cfg, layer_fn, outer, tokens, hist,
                               history_fn)
        alt = (dense_lm.forward(torch, cfg, layer_fn, outer, tokens, hist,
                                history_fn, precision="tf32")
               if control else None)
        out = _compare(ctx, outer, ref, alt, rows, served, kept)
    ctx.log(f"reference: {t} steps of {wl['batch']} sequences in "
            f"{time.perf_counter() - t_ref:.1f} s")
    return out


def _compare(ctx, outer, ref, alt, rows, served, kept):
    """The three numbers of the module docstring; with ``alt`` (the
    control) its logits, tokens and rows stand in for the program's."""
    torch = ctx.torch
    hidden, rk, rv = ref
    t = hidden.shape[1]
    if alt is not None:
        rows = list(zip(alt[1], alt[2]))
    kv_err = 0.0
    for (pk, pv), k, v in zip(rows, rk, rv):
        for p, r in ((pk, k), (pv, v)):
            kv_err = max(kv_err, _rel(torch, p, r))
    gap, lerr = 0.0, 0.0
    block = ctx.workload["check_block"]
    for s0 in range(0, t, block):
        s1 = min(t, s0 + block)
        lr = dense_lm.logits(torch, hidden[:, s0:s1], outer["head"])
        if alt is not None:
            la = dense_lm.logits(torch, alt[0][:, s0:s1], outer["head"],
                                 precision="tf32")
            pick = la.argmax(-1, keepdim=True)
            lerr = max(lerr, _rel(torch, la, lr))
        else:
            pick = served[:, s0:s1, None]
            for j in range(s0, s1):
                if j in kept:
                    lerr = max(lerr, _rel(torch, kept[j], lr[:, j - s0]))
        best = lr.amax(-1, keepdim=True)
        gaps = best - lr.gather(-1, pick)
        gap = max(gap, float(gaps.max()))
    return {"logit_gap": gap, "logits_err": lerr, "kv_err": kv_err}


def _rel(torch, p, r) -> float:
    """``max |p - r| / max |r|`` (NaN reads as infinity)."""
    d = (p.float() - r.float()).abs().max()
    s = r.float().abs().max().clamp_min(1e-30)
    v = float(d / s)
    return float("inf") if v != v else v
