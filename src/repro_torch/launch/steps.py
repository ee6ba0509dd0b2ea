"""Step functions and abstract inputs for every (arch x cell) pair.

``input_specs`` / ``decode_input_specs`` / ``abstract_state`` give every
model input and state as tensors on the ``meta`` device (shapes and
dtypes, no storage), mirroring the data pipeline's real batches.
``make_*_step`` return the functions that ``launch/train.py`` runs.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..optim.adamw import AdamW, AdamWState
from ..optim.compression import compress_in_place
from .cells import Cell

__all__ = ["abstract_state", "decode_input_specs", "input_specs",
           "make_decode_step", "make_prefill_step", "make_train_step",
           "make_value_and_grad", "model_flops"]

META = torch.device("meta")


# --------------------------------------------------------------------------
# abstract inputs
# --------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, cell: Cell) -> Dict[str, torch.Tensor]:
    """A train / prefill batch of this cell on the meta device."""
    b, s = cell.global_batch, cell.seq
    specs = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device=META),
        "labels": torch.empty((b, s), dtype=torch.int32, device=META),
        "loss_mask": torch.empty((b, s), dtype=torch.float32, device=META),
    }
    if cfg.frontend == "vision":
        specs["vision_embeds"] = torch.empty(
            (b, cfg.frontend_len, cfg.frontend_dim), device=META)
    if cfg.enc_dec:
        specs["enc_frames"] = torch.empty((b, s, cfg.frontend_dim),
                                          device=META)
    if cell.kind == "prefill":
        specs.pop("labels")
        specs.pop("loss_mask")
    return specs


def decode_input_specs(cfg: ModelConfig, cell: Cell,
                       cache_dtype=torch.bfloat16) -> Tuple[Any, Dict, Any]:
    """(tokens, caches, index) of a decode step on the meta device."""
    b, s = cell.global_batch, cell.seq
    tokens = torch.empty((b, 1), dtype=torch.int32, device=META)
    caches = lm.init_caches(cfg, b, max_len=s, dtype=cache_dtype,
                            device=META, enc_len=s if cfg.enc_dec else None)
    index = torch.empty((), dtype=torch.int32, device=META)
    return tokens, caches, index


def abstract_state(cfg: ModelConfig, opt: Optional[AdamW] = None
                   ) -> Tuple[lm.LM, Optional[AdamWState]]:
    """The parameters (and ``opt``'s state) on the meta device."""
    params = lm.abstract_params(cfg)
    return params, (None if opt is None else opt.init(params))


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------

def make_value_and_grad(cfg: ModelConfig, *, dtype=torch.bfloat16,
                        remat_policy: Optional[str] = None,
                        loss_chunks: int = 0, remat: bool = True,
                        cast_params: bool = False, act_spec=None):
    """(params, batch) -> ((loss, metrics), grads): the reference's
    ``jax.value_and_grad`` of its train step's loss.  ``grads`` is an
    ``LM`` of ``params``' shape (zeros where a weight gets none).

    ``cast_params`` casts every float32 weight, the norms too, to
    ``dtype`` before the layer loop, as the reference's flag does (its
    ZeRO-3 gathers then move the narrow weights); the gradients flow back
    through the cast to the float32 parameters.  ``act_spec`` is
    ``lm.forward``'s.
    """
    kw = dict(dtype=dtype, remat_policy=remat_policy,
              loss_chunks=loss_chunks, remat=remat, act_spec=act_spec)

    def value_and_grad(params: lm.LM, batch: Dict):
        params.requires_grad_(True)
        narrow = (lm.cast_view(params, dtype, norms=True)
                  if cast_params and dtype != torch.float32 else params)
        loss, metrics = lm.loss_fn(narrow, cfg, batch, **kw)
        named = dict(params.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        grads = lm.LM(cfg, {n: (torch.zeros_like(t) if g is None else g)
                            for (n, t), g in zip(named.items(), grads)})
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), grads
    return value_and_grad


def make_train_step(cfg: ModelConfig, opt: AdamW, *, dtype=torch.bfloat16,
                    remat_policy: Optional[str] = None,
                    grad_compress: Optional[str] = None,
                    loss_chunks: int = 0, cast_params: bool = False,
                    remat: bool = True, act_spec=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    The parameters and the state are updated in place (``AdamW.update``).
    ``grad_compress`` ("bf16" | "int8") round-trips the gradients first;
    the other options are ``make_value_and_grad``'s.  ``act_spec`` is a
    function applied to the residual stream after every layer: the dry
    run's DTensor redistribution, where the reference pins a
    PartitionSpec.  The reference's ``unroll`` (a scan's unrolling) has
    no counterpart in a Python layer loop.
    """
    value_and_grad = make_value_and_grad(
        cfg, dtype=dtype, remat_policy=remat_policy,
        loss_chunks=loss_chunks, remat=remat, cast_params=cast_params,
        act_spec=act_spec)

    def train_step(params, opt_state: AdamWState, batch):
        (_, metrics), grads = value_and_grad(params, batch)
        if grad_compress:
            compress_in_place(grads, grad_compress)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, metrics

    return train_step


def _cast_once(dtype):
    """params -> ``lm.cast_params(params, dtype)``, each parameter tree
    cast on its first call and the cast reused after (a float32 ``dtype``
    casts nothing)."""
    memo: "weakref.WeakKeyDictionary[lm.LM, lm.LM]" = \
        weakref.WeakKeyDictionary()

    def cast(params: lm.LM) -> lm.LM:
        if dtype == torch.float32:
            return params
        if params not in memo:
            memo[params] = lm.cast_params(params, dtype)
        return memo[params]
    return cast


def make_prefill_step(cfg: ModelConfig, *, dtype=torch.bfloat16):
    """(params, batch) -> (last-position logits, caches).

    Float32 parameters are cast to ``dtype`` with ``lm.cast_params`` on
    the step's first call with them, and the cast is reused by every later
    call (the reference casts at each use: the same rounding, without
    streaming the float32 weights each step).  A tree updated in place
    after its first call keeps its first cast: build a new step for it.
    """
    cast = _cast_once(dtype)

    @torch.no_grad()
    def prefill_step(params, batch):
        return lm.prefill(cast(params), cfg, batch, dtype=dtype)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, dtype=torch.bfloat16):
    """(params, tokens, caches, index) -> (logits, caches), the caches
    updated in place.

    ``index`` is a Python int, or a 0-d tensor that holds a value (not on
    the meta device: ``decode_input_specs``' index only gives its type;
    the dry run passes ``cell.seq - 1``).  The parameters are cast as in
    ``make_prefill_step``: once, on the first call with them.
    """
    cast = _cast_once(dtype)

    @torch.no_grad()
    def serve_step(params, tokens, caches, index):
        if isinstance(index, torch.Tensor):
            if index.is_meta:
                raise ValueError("a decode step's index must hold a value: "
                                 "pass a Python int, not a meta tensor")
            index = int(index)
        return lm.decode_step(cast(params), cfg, tokens, caches, index,
                              dtype=dtype)
    return serve_step


# --------------------------------------------------------------------------
# MODEL_FLOPS accounting
# --------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, cell: Cell) -> float:
    """6*N*D for training; 2*N*D for inference steps (forward only).

    MoE uses active params.  Decode counts one token per sequence plus the
    attention read over the cache (2 * B * L * S * kv_dim * 2 per step).
    """
    n = (cfg.active_param_count() if cfg.n_experts
         else cfg.param_count())
    b, s = cell.global_batch, cell.seq
    if cell.kind == "train":
        return 6.0 * n * b * s
    if cell.kind == "prefill":
        flops = 2.0 * n * b * s
        # quadratic attention term (hybrid: only the shared-block
        # applications)
        if cfg.family == "hybrid":
            layers = cfg.n_layers // cfg.attn_every
        elif cfg.family == "ssm":
            layers = 0
        else:
            layers = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
        flops += (2.0 * 2.0 * b * layers * s * s * cfg.n_heads
                  * (cfg.head_dim or 0))
        return flops
    # decode: one token
    flops = 2.0 * n * b
    if cfg.family == "hybrid":
        n_apps = cfg.n_layers // cfg.attn_every
        flops += 4.0 * b * n_apps * s * cfg.n_heads * cfg.head_dim
    elif cfg.family != "ssm":
        flops += 4.0 * b * cfg.n_layers * s * cfg.n_kv_heads * cfg.head_dim \
            * (cfg.n_heads // cfg.n_kv_heads)
    return flops
