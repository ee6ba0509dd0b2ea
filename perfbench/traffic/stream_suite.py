"""The paper's memory-bound suite, pass after pass, on one engine.

A pass makes one call of each item of the configuration's ``suite``, in
order, through the port's registry (``registry.get(op)(..., engine=...)``,
so ``Dispatcher.run`` and the launch path), with every input resident on
the card.  The window issues passes back to back without waiting for the
card and ends in a synchronisation; its rate counts each call's bytes
(``costs.kernels``) over the whole window.

The check compares the outputs of two passes, one drawn from the seed
among the first ``check_pass_window`` and the last, with the float64
reference on inputs made again from the seed.
"""
from __future__ import annotations

import time

from perfbench.costs import kernels as kernel_costs
from perfbench.harness import core, inputs
from perfbench.reference import stream as stream_ref


def _name(item: dict) -> str:
    return item.get("name", item["family"])


def _range(item: dict) -> str:
    name = _name(item)
    fam = item["family"]
    return f"pb.{fam}" if name == fam else f"pb.{fam}.{name}"


def setup(ctx):
    """The inputs from the seed, the calls, and two warm-up passes."""
    torch = ctx.torch
    esize = getattr(torch, core.stated_dtype(ctx.config)).itemsize
    from repro_torch.kernels import registry
    from repro_torch.kernels.spmv.ops import dense_to_bell
    from repro_torch.kernels.stencil.defs import suite as stencil_specs
    if ctx.backend == "cuda":
        core.build_kernels(ctx)
    t0 = time.perf_counter()
    calls = []
    for idx, item in enumerate(ctx.config["suite"]):
        inp = inputs.stream_item(torch, item, idx, ctx.seed, ctx.device)
        fam, kw = item["family"], {}
        if fam == "scale":
            args = (inp["b"], inp["q"])
            cost = kernel_costs.scale(item["n"], esize)
        elif fam == "triad":
            args = (inp["b"], inp["c"], inp["q"])
            cost = kernel_costs.triad(item["n"], esize)
        elif fam == "spmv":
            bm, bn = item["block"]
            bell = dense_to_bell(inp.pop("a"), bm=bm, bn=bn)
            args = (bell, inp["x"])
            nbr, mb = bell.cols.shape
            cost = kernel_costs.spmv_bell(nbr, mb, bm, bn, item["cols"],
                                          esize)
        elif fam == "stencil":
            args = (inp["u"], stencil_specs()[item["name"]])
            kw = {"steps": item["steps"]}
            points = 1 + 2 * len(item["shape"]) * len(item["wing"])
            cost = kernel_costs.stencil(points, item["steps"], item["shape"],
                                        esize)
        elif fam == "attention":
            args = (inp["q"], inp["k"], inp["v"], inp["kv_len"])
            cost = kernel_costs.flash_decode(
                item["b"], item["kh"], item["g"], item["dh"], item["s"],
                item["kv_len"], esize)
        else:
            raise KeyError(f"no suite family {fam!r}")
        calls.append({"range": _range(item), "op": registry.get(fam),
                      "args": args, "kw": kw, "cost": cost})
    state = {"calls": calls}
    ctx.sync()
    t = time.perf_counter()
    for _ in range(ctx.workload["warmup_passes"]):
        _pass(ctx, state)
    ctx.sync()
    ctx.log(f"setup: inputs {t - t0:.2f} s, warm-up "
            f"{time.perf_counter() - t:.2f} s")
    return state


def _pass(ctx, state):
    engine, backend = ctx.workload["engine"], ctx.backend
    outs = []
    for c in state["calls"]:
        with ctx.tracer.range(c["range"], work=c["cost"]):
            outs.append(c["op"](*c["args"], engine=engine, backend=backend,
                                **c["kw"]))
    return outs


def window(ctx, state):
    """Passes back to back for ``ctx.seconds``; keeps two passes' outputs."""
    k_check = core.subseed(ctx.seed, "check_pass") % \
        ctx.workload["check_pass_window"]
    per_pass = sum(c["cost"][0] for c in state["calls"])
    core.reset_launches()
    passes, pre_s, pre_passes, kept, outs = 0, None, 0, {}, None
    ctx.sync()
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds and not ctx.tracer.open:
            break
        was_open = ctx.tracer.open
        ctx.tracer.tick(elapsed)
        if ctx.tracer.open and not was_open:
            pre_s, pre_passes = ctx.tracer.opened_at - t0, passes
        outs = _pass(ctx, state)
        if passes == k_check:
            kept["sampled"] = outs
        passes += 1
    ctx.sync()
    seconds = time.perf_counter() - t0
    kept["last"] = outs
    if pre_s is None:
        pre_s, pre_passes = seconds, passes
    ctx.log(f"window: {passes} passes in {seconds:.3f} s; the check "
            f"compares pass {min(k_check, passes - 1)} and pass {passes - 1}")
    ctx.log(f"launches: {core.launches()}")
    return {"seconds": seconds, "passes": passes, "bytes_per_pass": per_pass,
            "bytes": passes * per_pass,
            "attempted": passes * len(state["calls"]),
            "pre_seconds": pre_s, "pre_passes": pre_passes, "kept": kept}


def check(ctx, state, record, control: bool = False):
    """``<item>_err`` per suite item: the largest error of the kept
    outputs (with ``control``, of the TF32 reference) against the float64
    reference, per element over its scale (``reference.stream``)."""
    torch = ctx.torch
    kept = record.pop("kept")
    state.clear()
    core.free(ctx)
    t_ref = time.perf_counter()
    numbers = {}
    for idx, item in enumerate(ctx.config["suite"]):
        inp = inputs.stream_item(torch, item, idx, ctx.seed, ctx.device)
        with torch.no_grad():
            ref, den = stream_ref.compute(torch, item, inp, "float64")
            if control:
                alt, _ = stream_ref.compute(torch, item, inp, "tf32")
                errs = [stream_ref.error(torch, alt, ref, den)]
            else:
                errs = [stream_ref.error(torch, outs[idx], ref, den)
                        for outs in kept.values()]
        numbers[f"{_name(item)}_err"] = max(errs)
        del inp, ref, den
        core.free(ctx)
    ctx.log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    return numbers
