"""Public decode-attention op, registered as an ``EngineOp``.

Single-token GQA attention is GEMV-shaped: I ~= 2*G/D flop/byte over the
KV cache, memory-bound by two orders of magnitude on the H100.  The
advisor (and the paper) say the only lever is streaming the cache once,
which both engine kernels do; they differ only in whether the per-tile
contractions run on the tensor cores or the CUDA cores.
"""
from __future__ import annotations

import math

import numpy as np

from ...carry import cast
from ...core.intensity import KernelTraits
from ..registry import EngineOp, register
from .flash_decode import flash_decode
from .ref import decode_attention_ref

__all__ = ["ATTENTION_OP", "decode_attention"]

#: Static KV-block length (what untuned dispatch uses, capped at S).
DEFAULT_BLOCK_S = 512

#: KV-block lengths a tuner may try: the reference kernel's block, and how
#: many positions one CTA streams where the B * KH pairs fill the card.
ATTENTION_TILE_SPACE = {"block_s": (128, 256, 512)}


def _traits(q, k, v, kv_len, *, block_s=None, split_pairs=None):
    del v, kv_len, block_s, split_pairs
    b, kh, g, dh = q.shape
    s = k.shape[1]
    work = 4.0 * b * kh * g * s * dh
    traffic = 2.0 * b * s * kh * dh * k.element_size()
    return KernelTraits("flash_decode", work, traffic)


def _clamp_block_s(s: int, block_s) -> int:
    """Largest divisor of the cache length not exceeding the request.

    A tuned block_s must stay valid for every cache length it meets; gcd
    keeps it a divisor of S (power-of-two block candidates make this
    exact).  Serving caches are not block-aligned (prompt 8 + gen 4 = 12).
    """
    bs = min(int(block_s), s)
    return max(math.gcd(s, bs), 1)


def _engine_fn(engine: str):
    def call(q, k, v, kv_len, *, block_s=None, split_pairs=None,
             backend: str = "cuda"):
        if block_s is None:
            block_s = DEFAULT_BLOCK_S
        bs = _clamp_block_s(k.shape[1], block_s)
        return flash_decode(q, k, v, kv_len, block_s=bs, engine=engine,
                            backend=backend, split_pairs=split_pairs)
    return call


def _reference(q, k, v, kv_len, *, block_s=None, split_pairs=None):
    del block_s, split_pairs
    return decode_attention_ref(q, k, v, kv_len)


def _make_inputs(rng: np.random.Generator, size: int, dtype: str = "float32",
                 device: str = "cuda"):
    """size = KV-cache length; a small GQA decode step against it."""
    b, kh, g, dh = 1, 2, 4, 64
    q = cast(rng.standard_normal((b, kh, g, dh)), dtype, device)
    k = cast(rng.standard_normal((b, size, kh, dh)), dtype, device)
    v = cast(rng.standard_normal((b, size, kh, dh)), dtype, device)
    return (q, k, v, size - size // 8), {}


ATTENTION_OP = register(EngineOp(
    name="attention",
    traits=_traits,
    engines={"vector": _engine_fn("vector"), "matrix": _engine_fn("matrix")},
    reference=_reference,
    make_inputs=_make_inputs,
    bench_sizes=(256, 512),
    dtypes=("float32", "bfloat16"),
    test_size=256,
    doc="flash-decode GQA attention over a KV cache; I ~= 2G/D",
    tile_space=ATTENTION_TILE_SPACE,
    tile_defaults={"block_s": DEFAULT_BLOCK_S},
    # mesh split: KV heads are independent (each attends to its own
    # cache slice), so head-sharding is exact with no exchange; a head
    # shard's kwargs carry the unsharded call's B * KH as split_pairs
    shard_kind="head",
))


def decode_attention(q, k, v, kv_len: int, *, engine: str = "auto",
                     block_s: int = None, backend: str = "cuda"):
    """Single-token GQA attention against a KV cache.

    Intensity ~= (4 flops per cache element) / (2 cache bytes per
    element): memory-bound, so 'auto' routes to the vector kernel, with
    the tensor-core kernel one flag away (and, per the paper, no
    faster).  ``block_s=None`` means the static default of 512, clamped
    to a divisor of S.
    """
    return ATTENTION_OP(q, k, v, kv_len, engine=engine, block_s=block_s,
                        backend=backend)
