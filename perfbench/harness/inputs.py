"""The cells' inputs, made on the device from the seed.

The same seed gives the same tensors, and each tensor comes from its own
generator stream (``core.subseed``), so the reference can make any one of
them again (one layer's weights, one layer's history) without the rest.
The program and the reference are both handed what these functions make;
the reference never reads what the program derived from it.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

from . import core


def scalar(seed: int, *tags) -> float:
    """A multiplier ``1 + k/256`` (k in 1..255) for the stream ``tags``:
    exact in float32, so both sides start from the same number."""
    return 1.0 + (1 + core.subseed(seed, *tags) % 255) / 256.0


def stream_item(torch, item: dict, index: int, seed: int, device
                ) -> Dict[str, object]:
    """The inputs of one call of the suite (``item`` of a configuration's
    ``suite``), float32 on ``device``."""
    fam = item["family"]

    def randn(name, shape):
        g = core.generator(torch, device, seed, "suite", index, fam, name)
        return torch.randn(tuple(shape), generator=g, device=device)
    if fam in ("scale", "triad"):
        out = {"b": randn("b", (item["n"],)),
               "q": scalar(seed, "suite", index, fam, "q")}
        if fam == "triad":
            out["c"] = randn("c", (item["n"],))
        return out
    if fam == "spmv":
        shape = (item["rows"], item["cols"])
        a = randn("a", shape)
        g = core.generator(torch, device, seed, "suite", index, fam, "keep")
        keep = torch.rand(shape, generator=g, device=device) < item["density"]
        a.mul_(keep)
        del keep
        return {"a": a, "x": randn("x", (item["cols"],))}
    if fam == "stencil":
        return {"u": randn("u", item["shape"])}
    if fam == "attention":
        b, kh, g_, dh, s = (item[k] for k in ("b", "kh", "g", "dh", "s"))
        return {"q": randn("q", (b, kh, g_, dh)),
                "k": randn("k", (b, s, kh, dh)),
                "v": randn("v", (b, s, kh, dh)),
                "kv_len": int(item["kv_len"])}
    raise KeyError(f"no inputs for suite family {fam!r}")


def _layer_shapes(cfg: dict):
    """(name, shape, scale) of one layer's matrix weights, in the order
    they are cut from the layer's one draw."""
    d, dh, f = cfg["hidden_size"], cfg["head_dim"], cfg["intermediate_size"]
    q = cfg["num_attention_heads"] * dh
    kv = cfg["num_key_value_heads"] * dh
    return (("attn.wq", (d, q), d), ("attn.wk", (d, kv), d),
            ("attn.wv", (d, kv), d), ("attn.wo", (q, d), q),
            ("mlp.w_gate", (d, f), d), ("mlp.w_up", (d, f), d),
            ("mlp.w_down", (f, d), f))


def dense_layer(torch, cfg: dict, seed: int, layer: int, device
                ) -> Dict[str, object]:
    """One layer's weights, in one draw: each matrix N(0, 1/d_in) as
    ``x @ W`` takes it, the two norms 1 + N(0, 0.1^2) (so that a norm
    that is skipped shows)."""
    shapes = _layer_shapes(cfg)
    d = cfg["hidden_size"]
    total = sum(math.prod(s) for _, s, _ in shapes) + 2 * d
    g = core.generator(torch, device, seed, "layer", layer)
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape, d_in in shapes:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(1.0 / math.sqrt(d_in))
        off += n
    for name in ("ln1", "ln2"):
        out[name] = flat[off:off + d].mul_(0.1).add_(1.0)
        off += d
    return out


def dense_outer(torch, cfg: dict, seed: int, device) -> Dict[str, object]:
    """The embedding (N(0, 0.02^2)), the LM head (N(0, 0.02^2)) and the
    final norm (1 + N(0, 0.1^2))."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    emb = torch.randn((v, d), generator=core.generator(
        torch, device, seed, "embed"), device=device).mul_(0.02)
    head = torch.randn((d, v), generator=core.generator(
        torch, device, seed, "head"), device=device).mul_(0.02)
    norm = torch.randn(d, generator=core.generator(
        torch, device, seed, "final_norm"), device=device).mul_(0.1).add_(1.0)
    return {"embed": emb, "head": head, "final_norm": norm}


def history(torch, cfg: dict, wl: dict, seed: int, layer: int, device
            ) -> Tuple[object, object]:
    """Layer ``layer``'s K and V rows of the decode history, (batch,
    history, KV heads, head dim) each, N(0, 1): the long document each
    session reads, as it stands in the cache (keys after RoPE)."""
    shape = (wl["batch"], wl["history"], cfg["num_key_value_heads"],
             cfg["head_dim"])
    return tuple(torch.randn(shape, generator=core.generator(
        torch, device, seed, "history", layer, kv), device=device)
        for kv in ("k", "v"))


def request_tokens(torch, cfg: dict, wl: dict, seed: int, request: int,
                   device):
    """The first token of each sequence of request ``request``: (batch,
    1) int64, uniform over the vocabulary."""
    g = core.generator(torch, device, seed, "request", request)
    return torch.randint(0, cfg["vocab_size"], (wl["batch"], 1),
                         generator=g, device=device)
