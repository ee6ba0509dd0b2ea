"""Bytes and operations of one decode step of DeepSeek-V2 (an expert
share of it: MLA attention, a leading dense layer, then MoE layers of
held routed experts, shared experts and a router over every expert),
from a configuration file's sizes, and of its parts:

* ``mla``: the absorbed latent attention of every layer: the latent and
  rope-key rows of the ``kv_len`` valid positions read once; operations,
  a multiply-add per query head for the absorption of q into the latent
  (``qk_nope x kv_lora``), each position's scores against the latent and
  the rope key, each position's weighted latent sum, and ``w_uv``;
* ``moe``: the MoE layers: the router, the shared experts and the
  *touched* held experts (those rows were routed to, as the program
  counts them) read once; a multiply-add per weight and token for the
  router and the shared experts, per weight and routed row for the held
  experts;
* ``experts``: the grouped expert kernel alone: the touched experts'
  weights, and each routed row read, its hidden row written and read,
  its output row written;
* ``step``: the whole step: every other weight (q's LoRA, ``wkv_a``,
  ``wkv_b``, ``wo``, the dense layer's SwiGLU, the LM head) read once with
  a multiply-add per weight and token (``wkv_b``'s operations are
  ``mla``'s absorption and ``w_uv``), the new latent and rope-key rows
  written and the logits written, plus ``mla`` and ``moe``.

``touched`` and ``rows`` are summed over the step's MoE layers.  Norms,
the embedding rows, softmax and activations are left out: under a
thousandth of the bytes.
"""
from __future__ import annotations

from typing import Tuple


def _moe_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def mla(cfg: dict, batch: int, kv_len: int, esize: int = 4
        ) -> Tuple[float, float]:
    """(bytes, flops) of one step's absorbed MLA over ``kv_len`` valid
    positions, every layer."""
    layers = cfg["num_hidden_layers"]
    h, r, rd = (cfg["num_attention_heads"], cfg["kv_lora_rank"],
                cfg["qk_rope_head_dim"])
    nope, vd = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    nbytes = layers * batch * kv_len * (r + rd) * esize
    macs = h * (nope * r + kv_len * (r + rd) + kv_len * r + r * vd)
    return float(nbytes), 2.0 * layers * batch * macs


def _expert_weights(cfg: dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def moe(cfg: dict, batch: int, touched: int, rows: int, esize: int = 4
        ) -> Tuple[float, float]:
    """(bytes, flops) of one step's MoE layers with ``touched`` held
    experts touched and ``rows`` rows routed to them, over the layers."""
    d = cfg["hidden_size"]
    per_layer = (d * cfg["n_routed_experts_published"]
                 + cfg["n_shared_experts"] * _expert_weights(cfg))
    n = _moe_layers(cfg)
    nbytes = (n * per_layer + touched * _expert_weights(cfg)) * esize
    flops = 2.0 * (n * batch * per_layer + rows * _expert_weights(cfg))
    return float(nbytes), flops


def experts(cfg: dict, touched: int, rows: int, esize: int = 4
            ) -> Tuple[float, float]:
    """(bytes, flops) of the grouped expert kernel's calls in one step."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    nbytes = (touched * _expert_weights(cfg) + rows * (2 * d + 2 * f)) * esize
    return float(nbytes), 2.0 * rows * _expert_weights(cfg)


def other_weights(cfg: dict) -> int:
    """The step's weights outside ``moe`` and ``mla``'s operations: every
    layer's q LoRA, ``wkv_a``, ``wkv_b`` and ``wo``, the dense layers'
    SwiGLU and the LM head."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qr, r, rd = cfg["q_lora_rank"], cfg["kv_lora_rank"], \
        cfg["qk_rope_head_dim"]
    nope, vd = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    attn = (d * qr + qr * h * (nope + rd) + d * (r + rd)
            + r * h * (nope + vd) + h * vd * d)
    dense = cfg["first_k_dense_replace"] * 3 * d * cfg["intermediate_size"]
    return (cfg["num_hidden_layers"] * attn + dense
            + d * cfg["vocab_size"])


def step(cfg: dict, batch: int, kv_len: int, touched: int, rows: int,
         esize: int = 4) -> Tuple[float, float]:
    """(bytes, flops) of one whole decode step (module docstring)."""
    h = cfg["num_attention_heads"]
    r, rd = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    nope, vd = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    w = other_weights(cfg)
    wkv_b = cfg["num_hidden_layers"] * r * h * (nope + vd)
    rows_written = cfg["num_hidden_layers"] * batch * (r + rd)
    nbytes = (w + rows_written) * esize + batch * cfg["vocab_size"] * 4
    flops = 2.0 * batch * (w - wkv_b)
    for part in (mla(cfg, batch, kv_len, esize),
                 moe(cfg, batch, touched, rows, esize)):
        nbytes, flops = nbytes + part[0], flops + part[1]
    return float(nbytes), flops
