"""Reference of the paper's suite: SCALE, Triad, block-ELL SpMV (as the
dense product it stands for), the zero-boundary stencils and single-token
attention, in float64, with each output's error scale.

``compute(torch, item, inp, precision)`` returns ``(out, den)``: the
output in float64 (``precision="float64"``) or in the control's TF32
(``"tf32"``), and per element the sum of the absolute values of the terms
that make it (the scale a rounding error is judged against), in float64.
"""
from __future__ import annotations

import math

from . import no_tf32, tf32


def _shift(torch, u, axis: int, d: int):
    """``out[p] = u[p + d e_axis]``, zeros outside the domain."""
    out = torch.zeros_like(u)
    n = u.shape[axis]
    if abs(d) >= n:
        return out
    dst = [slice(None)] * u.ndim
    src = [slice(None)] * u.ndim
    dst[axis] = slice(max(0, -d), n - max(0, d))
    src[axis] = slice(max(0, d), n - max(0, -d))
    out[tuple(dst)] = u[tuple(src)]
    return out


def star(torch, u, center: float, wing, steps: int, rnd=None):
    """``steps`` steps of a star stencil with zero boundary: each step
    ``center u + sum over axes and distances d of wing[d-1] (u(+d) +
    u(-d))``; ``rnd`` rounds every operand (the control)."""
    rnd = rnd or (lambda t: t)
    c = rnd(torch.tensor(center, dtype=u.dtype, device=u.device))
    ws = [rnd(torch.tensor(w, dtype=u.dtype, device=u.device)) for w in wing]
    for _ in range(steps):
        u = rnd(u)
        acc = c * u
        for axis in range(u.ndim):
            for d, w in enumerate(ws, start=1):
                acc = acc + w * _shift(torch, u, axis, d)
                acc = acc + w * _shift(torch, u, axis, -d)
        u = acc
    return u


def compute(torch, item: dict, inp: dict, precision: str = "float64"):
    """(output, error scale) of one suite call (see the module)."""
    no_tf32(torch)
    fam = item["family"]
    ctl = precision == "tf32"
    if precision not in ("float64", "tf32"):
        raise ValueError(f"precision {precision!r}")

    def r(t):
        return tf32(torch, t.float()) if ctl else t.double()
    if fam == "scale":
        b, q = inp["b"], inp["q"]
        out = r(torch.tensor(q, device=b.device)) * r(b)
        return out, b.double().abs() * abs(q)
    if fam == "triad":
        b, c, q = inp["b"], inp["c"], inp["q"]
        out = r(b) + r(torch.tensor(q, device=b.device)) * r(c)
        return out, b.double().abs() + abs(q) * c.double().abs()
    if fam == "spmv":
        a, x = inp["a"], inp["x"]
        out = r(a) @ r(x)
        return out, a.double().abs() @ x.double().abs()
    if fam == "stencil":
        u = inp["u"]
        out = star(torch, u.float() if ctl else u.double(), item["center"],
                   item["wing"], item["steps"],
                   rnd=(lambda t: tf32(torch, t)) if ctl else None)
        den = star(torch, u.double().abs(), abs(item["center"]),
                   [abs(w) for w in item["wing"]], item["steps"])
        return out, den
    if fam == "attention":
        q, k, v, kv_len = inp["q"], inp["k"], inp["v"], inp["kv_len"]
        used = min(kv_len, k.shape[1]) if kv_len >= 1 else k.shape[1]
        kk, vv = k[:, :used], v[:, :used]
        scale = 1.0 / math.sqrt(q.shape[-1])
        s = torch.einsum("bhgd,bshd->bhgs", r(q), r(kk)) * scale
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgs,bshd->bhgd", r(p), r(vv))
        den = torch.einsum("bhgs,bshd->bhgd", p.double(), vv.double().abs())
        return out, den
    raise KeyError(f"no reference for suite family {fam!r}")


def error(torch, out, ref, den) -> float:
    """The largest ``|out - ref| / den`` over the elements (den floored
    at 1e-30); NaN anywhere reads as infinity."""
    diff = (out.double().reshape(ref.shape) - ref).abs()
    rel = diff / den.clamp_min(1e-30)
    if torch.isnan(rel).any():
        return float("inf")
    return float(rel.max()) if rel.numel() else 0.0
