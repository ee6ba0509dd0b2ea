"""Bytes and operations of the parts of one decode step of a dense GQA
language model, from a configuration file's sizes, counted as
``decode.step`` counts the whole step:

* ``attention_proj``: the q, k, v and o weights of every layer read
  once, and the step's new K and V rows written;
* ``mlp``: the three SwiGLU matrices of every layer read once;
* ``head``: the LM head read once and the logits written.

Each part's operations are a multiply-add per weight and token.  These
three and flash-decode over the ``kv_len`` valid positions of every layer
(``kernels.flash_decode``) make the whole step: its operations exactly,
and its bytes plus flash-decode's q read and output written, which
``decode.step`` leaves out.
"""
from __future__ import annotations

from typing import Tuple


def _proj_weights(cfg: dict) -> int:
    d, dh = cfg["hidden_size"], cfg["head_dim"]
    q = cfg["num_attention_heads"] * dh
    kv = cfg["num_key_value_heads"] * dh
    return d * q + 2 * d * kv + q * d


def attention_proj(cfg: dict, batch: int, esize: int = 4
                   ) -> Tuple[float, float]:
    """(bytes, flops) of one step's q, k, v and o projections, every
    layer, with the new K and V rows written."""
    layers = cfg["num_hidden_layers"]
    weights = layers * _proj_weights(cfg)
    kv_write = layers * 2 * batch * cfg["num_key_value_heads"] * \
        cfg["head_dim"]
    return float((weights + kv_write) * esize), 2.0 * batch * weights


def mlp(cfg: dict, batch: int, esize: int = 4) -> Tuple[float, float]:
    """(bytes, flops) of one step's SwiGLU FFNs, every layer."""
    weights = cfg["num_hidden_layers"] * 3 * cfg["hidden_size"] * \
        cfg["intermediate_size"]
    return float(weights * esize), 2.0 * batch * weights


def head(cfg: dict, batch: int, esize: int = 4) -> Tuple[float, float]:
    """(bytes, flops) of one step's LM head: its matrix read, the float32
    logits written."""
    weights = cfg["hidden_size"] * cfg["vocab_size"]
    return (float(weights * esize + batch * cfg["vocab_size"] * 4),
            2.0 * batch * weights)
