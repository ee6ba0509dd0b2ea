"""Bytes and operations of one decode step of a dense GQA language model
(pre-norm attention and SwiGLU layers, untied LM head), from a
configuration file's sizes.

Bytes: every matrix weight and the LM head read once, the K and V of
the ``kv_len`` valid positions of every layer read (the step's own new
row among them), the new K and V rows written, and the logits written.
Operations: a multiply-add per weight and token, and the attention's two
products over the valid positions.  Norms, the embedding rows and
activations are left out: they are under a thousandth of the bytes.
"""
from __future__ import annotations

from typing import Tuple


def layer_weights(cfg: dict) -> int:
    """Matrix weights of one layer: q, k, v, o and the SwiGLU's three."""
    d, dh = cfg["hidden_size"], cfg["head_dim"]
    q = cfg["num_attention_heads"] * dh
    kv = cfg["num_key_value_heads"] * dh
    return d * q + 2 * d * kv + q * d + 3 * d * cfg["intermediate_size"]


def step(cfg: dict, batch: int, kv_len: int, esize: int = 4
         ) -> Tuple[float, float]:
    """(bytes, flops) of one step of ``batch`` tokens that attend over
    ``kv_len`` positions each (the new one included)."""
    layers = cfg["num_hidden_layers"]
    d, dh, v = cfg["hidden_size"], cfg["head_dim"], cfg["vocab_size"]
    kh, h = cfg["num_key_value_heads"], cfg["num_attention_heads"]
    weights = layers * layer_weights(cfg) + d * v
    kv_read = layers * 2 * batch * kv_len * kh * dh
    kv_write = layers * 2 * batch * kh * dh
    nbytes = (weights + kv_read + kv_write) * esize + batch * v * 4
    flops = 2.0 * batch * weights + layers * 4.0 * batch * h * kv_len * dh
    return float(nbytes), flops
