"""Causal LM, every family of ``configs/``: a module per layer, a layer
loop.

The reference scans a stacked parameter pytree with ``lax.scan``; here
each layer is an ``nn.Module`` in an ``nn.ModuleList`` and the layer loop
is a Python loop (PyTorch runs eagerly, so there is nothing to compile).
The weight names and layouts are the reference's: ``(d_in, d_out)`` for
``x @ W``, ``state_dict`` keys ``layers.<i>.attn.wq`` for the pytree's
``layers/attn/wq[i]``.  A MoE config's leading dense layers
(``first_dense_layers``, DeepSeek-V2-Lite's first) are ``first_dense.<i>``
as the reference stacks them under ``first_dense``; its other layers
carry a ``moe`` group (router, experts, ``shared`` experts) in place of
``mlp``: for an ``ExpertShareConfig`` the layer's share of the experts
(``moe.share_ffn``), with a router over every expert.  An SSM config's
layers are ``layers.<i>.ssm.w_z``; a hybrid
config (Zamba2) nests its super-blocks as the reference stacks them,
``layers.<s>.<j>.ssm.w_z`` for ``layers/ssm/w_z[s, j]``, then ``tail.<i>``
and the one ``shared_attn`` dense layer applied after every super-block.
An encoder-decoder config (SeamlessM4T) adds the ``encoder`` stack
(``encoder.<i>``, dense layers without cross-attention) and ``enc_norm``,
and its decoder layers carry ``ln_cross`` and a ``cross`` attention
group; a config with a modality frontend (the audio frames of SeamlessM4T,
the vision patches of Qwen2-VL) adds the ``frontend`` group (``proj``,
``bias``), the stub the reference puts in place of the real encoder of
that modality.

Modes:
  forward      -- full-sequence pass (logits, optional KV / SSM caches),
                  each layer recomputed in the backward pass (remat)
  loss_fn      -- teacher-forced training loss (masked next-token NLL +
                  the MoE's aux and z losses)
  prefill      -- prompt pass returning last-position logits + caches
  decode_step  -- one token against the caches (float or int8), updated
                  in place

The weights are frozen (``requires_grad`` off) as built: serving computes
no gradients.  Training turns them on (``params.requires_grad_(True)``,
as ``launch.steps.make_train_step`` does).
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..obs.trace import TRACER
from .attention import attention, cross_attend, make_cache
from .config import ModelConfig
from .layers import dense_init, init_mlp, mlp, rmsnorm
from .moe import init_moe, moe_ffn
from .ssm import init_ssm, make_ssm_state, ssm_layer

__all__ = ["Block", "DenseLayer", "LM", "SSMLayer", "abstract_params",
           "cast_params", "cast_view", "check_family", "decode_step",
           "forward", "init_caches", "init_params", "loss_fn", "pad_caches",
           "prefill"]

#: The reference's model features still to port, with the ROADMAP.md item
#: of each: none (Queue 1 items 10.1-10.8 are done).
WAITING: Dict[str, str] = {}


#: The modality frontends: vision patches replace the first positions of
#: the decoder's input, audio frames feed the encoder.
FRONTENDS = (None, "vision", "audio")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a frontend the layer loop does not know;
    every config in ``configs/`` runs."""
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} is none "
                         f"of {FRONTENDS}")


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

class Block(nn.Module):
    """A named group of weights: one node of the reference's pytree.

    A dotted name (``shared.w_gate``) makes a nested group.  ``"bq" in
    block`` tests for an optional weight or group, as ``"bq" in p`` does
    on the reference's dicts.
    """

    def __init__(self, tensors: Mapping[str, torch.Tensor],
                 view: bool = False):
        super().__init__()
        groups: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, t in tensors.items():
            head, _, rest = name.partition(".")
            if rest:
                groups.setdefault(head, {})[rest] = t
            else:
                _hold(self, name, t, view)
        for head, sub in groups.items():
            self.add_module(head, Block(sub, view))

    def __contains__(self, name: str) -> bool:
        return (name in self._parameters or name in self._buffers
                or name in self._modules)


def _hold(module: nn.Module, name: str, t: torch.Tensor, view: bool):
    """``t`` as ``module.<name>``: a frozen parameter, or in a view the
    tensor itself (a buffer), which keeps a view made from parameters in
    their autograd graph."""
    if view:
        module.register_buffer(name, t)
    else:
        module.register_parameter(name, nn.Parameter(t, requires_grad=False))


def _group(tensors: Mapping[str, torch.Tensor], prefix: str
           ) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in tensors.items()
            if k.startswith(prefix)}


class DenseLayer(nn.Module):
    """Pre-norm attention + FFN block: a SwiGLU ``mlp``, or a ``moe``
    (``mlp`` / ``moe`` is None where the layer has the other); an
    encoder-decoder's decoder layer also has ``ln_cross`` and the
    ``cross`` attention (None elsewhere)."""

    def __init__(self, tensors: Mapping[str, torch.Tensor],
                 view: bool = False):
        super().__init__()
        _hold(self, "ln1", tensors["ln1"], view)
        _hold(self, "ln2", tensors["ln2"], view)
        self.attn = Block(_group(tensors, "attn."), view)
        moe = _group(tensors, "moe.")
        self.moe = Block(moe, view) if moe else None
        self.mlp = None if moe else Block(_group(tensors, "mlp."), view)
        cross = _group(tensors, "cross.")
        if cross:
            _hold(self, "ln_cross", tensors["ln_cross"], view)
        else:
            self.ln_cross = None
        self.cross = Block(cross, view) if cross else None


class SSMLayer(nn.Module):
    """Pre-norm Mamba2 block: ``ln1`` then the ``ssm`` mixer's weights."""

    def __init__(self, tensors: Mapping[str, torch.Tensor],
                 view: bool = False):
        super().__init__()
        _hold(self, "ln1", tensors["ln1"], view)
        self.ssm = Block(_group(tensors, "ssm."), view)


class LM(nn.Module):
    """Embedding, the layer stack and the LM head of one ``ModelConfig``.

    ``tensors`` maps ``state_dict`` names (``embed``, ``final_norm``,
    ``head``, ``layers.<i>.ln1``, ``layers.<i>.attn.wq``,
    ``first_dense.<i>.mlp.w_up``, ``layers.<s>.<j>.ssm.w_z``,
    ``shared_attn.attn.wq``, ``encoder.<i>.attn.wq``,
    ``layers.<i>.cross.wq``, ``frontend.proj``, ...) to the weights, which
    the module takes over without copying.  A ``view`` holds them as they
    are (buffers, not parameters): ``cast_view`` casts an LM's weights
    inside the autograd graph so.
    """

    def __init__(self, cfg: ModelConfig,
                 tensors: Mapping[str, torch.Tensor], view: bool = False):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        _hold(self, "embed", tensors["embed"], view)
        _hold(self, "final_norm", tensors["final_norm"], view)
        if not cfg.tie_embeddings:
            _hold(self, "head", tensors["head"], view)
        if cfg.frontend:
            self.frontend = Block(_group(tensors, "frontend."), view)
        if cfg.enc_dec:
            self.encoder = nn.ModuleList(
                DenseLayer(_group(tensors, f"encoder.{i}."), view)
                for i in range(cfg.n_enc_layers))
            _hold(self, "enc_norm", tensors["enc_norm"], view)
        if cfg.family == "ssm":
            self.layers = nn.ModuleList(
                SSMLayer(_group(tensors, f"layers.{i}."), view)
                for i in range(cfg.n_layers))
            return
        if cfg.family == "hybrid":
            n_super, n_tail = divmod(cfg.n_layers, cfg.attn_every)
            self.layers = nn.ModuleList(
                nn.ModuleList(SSMLayer(_group(tensors, f"layers.{s}.{j}."),
                                       view)
                              for j in range(cfg.attn_every))
                for s in range(n_super))
            self.tail = nn.ModuleList(
                SSMLayer(_group(tensors, f"tail.{i}."), view)
                for i in range(n_tail))
            self.shared_attn = DenseLayer(_group(tensors, "shared_attn."),
                                          view)
            return
        nf = cfg.first_dense_layers
        self.first_dense = nn.ModuleList(
            DenseLayer(_group(tensors, f"first_dense.{i}."), view)
            for i in range(nf))
        self.layers = nn.ModuleList(
            DenseLayer(_group(tensors, f"layers.{i}."), view)
            for i in range(cfg.n_layers - nf))


#: Parameters that stay float32 whatever the compute dtype: the reference
#: applies them in float32 (``rmsnorm``; the SSM's decay, dt bias and skip
#: in float32 arithmetic) and never casts them.
_NORMS = ("ln1", "ln2", "ln_cross", "final_norm", "enc_norm", "kv_norm",
          "q_norm", "a_log", "dt_bias", "d_skip", "norm")


def _cast(tensors: Mapping[str, torch.Tensor], dtype: torch.dtype
          ) -> Dict[str, torch.Tensor]:
    return {k: (v if k.split(".")[-1] in _NORMS else v.to(dtype))
            for k, v in tensors.items()}


def cast_params(p: LM, dtype: torch.dtype) -> LM:
    """``p`` with every matmul weight, embedding and bias in ``dtype``.

    Done once, where the reference casts at every use (``.astype(dtype)``
    before each matmul): the same rounding, without streaming the
    float32 weights a second time each step.  Norm weights stay float32.
    A float32 ``dtype`` returns ``p`` itself.
    """
    if dtype == torch.float32:
        return p
    return LM(p.cfg, _cast(p.state_dict(), dtype))


def cast_view(p: LM, dtype: torch.dtype, norms: bool = False) -> LM:
    """``p``'s weights in ``dtype`` (the norms too with ``norms``), cast
    inside the autograd graph: gradients of a loss computed on the view
    reach ``p``'s own parameters.  The reference casts at every use; one
    cast per step rounds the same."""
    tensors = p.state_dict(keep_vars=True)
    if norms:
        tensors = {k: (v.to(dtype) if v.dtype == torch.float32 else v)
                   for k, v in tensors.items()}
    return LM(p.cfg, _cast(tensors, dtype), view=True)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                    cross: bool = False) -> Dict[str, torch.Tensor]:
    """One attention's weights: MLA's, or GQA's (a cross-attention is
    always GQA)."""
    d = cfg.d_model
    if cfg.use_mla and not cross:
        r, h = cfg.kv_lora_rank, cfg.n_heads
        nope, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        t = {"wkv_a": dense_init(gen, d, r + rd, device=device),
             "kv_norm": torch.ones(r, device=device),
             "wkv_b": dense_init(gen, r, h * (nope + vd), device=device),
             "wo": dense_init(gen, h * vd, d, device=device)}
        if cfg.q_lora_rank:
            t["wq_a"] = dense_init(gen, d, cfg.q_lora_rank, device=device)
            t["q_norm"] = torch.ones(cfg.q_lora_rank, device=device)
            t["wq_b"] = dense_init(gen, cfg.q_lora_rank, h * (nope + rd),
                                   device=device)
        else:
            t["wq"] = dense_init(gen, d, h * (nope + rd), device=device)
        return t
    t = {"wq": dense_init(gen, d, cfg.q_dim, device=device),
         "wk": dense_init(gen, d, cfg.kv_dim, device=device),
         "wv": dense_init(gen, d, cfg.kv_dim, device=device),
         "wo": dense_init(gen, cfg.n_heads * cfg.head_dim, d, device=device)}
    if cfg.qkv_bias:
        t["bq"] = torch.zeros(cfg.q_dim, device=device)
        t["bk"] = torch.zeros(cfg.kv_dim, device=device)
        t["bv"] = torch.zeros(cfg.kv_dim, device=device)
    return t


def _init_dense_layer(gen: torch.Generator, cfg: ModelConfig, device,
                      d_ff: Optional[int], cross: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """One layer's weights: attention, then a SwiGLU of ``d_ff``, or the
    MoE where ``d_ff`` is None; ``cross`` adds ``ln_cross`` and the
    cross-attention."""
    d = cfg.d_model
    t = {"ln1": torch.ones(d, device=device),
         "ln2": torch.ones(d, device=device)}
    t.update({f"attn.{k}": v
              for k, v in _init_attention(gen, cfg, device).items()})
    if d_ff is None:
        t.update({f"moe.{k}": v
                  for k, v in init_moe(gen, cfg, device).items()})
    else:
        t.update({f"mlp.{k}": v
                  for k, v in init_mlp(gen, d, d_ff, device=device).items()})
    if cross:
        t["ln_cross"] = torch.ones(d, device=device)
        t.update({f"cross.{k}": v for k, v in
                  _init_attention(gen, cfg, device, cross=True).items()})
    return t


def _init_ssm_layer(gen: torch.Generator, cfg: ModelConfig, device
                    ) -> Dict[str, torch.Tensor]:
    t = {"ln1": torch.ones(cfg.d_model, device=device)}
    t.update({f"ssm.{k}": v for k, v in init_ssm(gen, cfg, device).items()})
    return t


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """Seeded random float32 weights, drawn on ``device``.

    The reference's distributions (N(0, 1/d_in) matmul, expert and
    frontend weights, 0.02 embedding, head and router, unit norms, zero
    biases; the SSM's as ``ssm.init_ssm``) from a ``torch.Generator``: not
    the reference's numbers, which come from ``jax.random`` (carry them
    with ``carry.params_from_numpy``).  On the ``meta`` device the shapes
    alone (``abstract_params``).
    """
    check_family(cfg)
    gen = (None if torch.device(device).type == "meta" else
           torch.Generator(device=device).manual_seed(seed))
    d = cfg.d_model
    t = {"embed": torch.randn((cfg.vocab_padded, d), generator=gen,
                              device=device).mul_(0.02),
         "final_norm": torch.ones(d, device=device)}
    if not cfg.tie_embeddings:
        t["head"] = dense_init(gen, d, cfg.vocab_padded, scale=0.02,
                               device=device)

    def add(prefix, layer):
        t.update({f"{prefix}.{k}": v for k, v in layer.items()})
    if cfg.frontend:
        t["frontend.proj"] = dense_init(gen, cfg.frontend_dim, d,
                                        device=device)
        t["frontend.bias"] = torch.zeros(d, device=device)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            add(f"layers.{i}", _init_ssm_layer(gen, cfg, device))
        return LM(cfg, t)
    if cfg.family == "hybrid":
        n_super, n_tail = divmod(cfg.n_layers, cfg.attn_every)
        for s in range(n_super):
            for j in range(cfg.attn_every):
                add(f"layers.{s}.{j}", _init_ssm_layer(gen, cfg, device))
        for i in range(n_tail):
            add(f"tail.{i}", _init_ssm_layer(gen, cfg, device))
        add("shared_attn", _init_dense_layer(gen, cfg, device, cfg.d_ff))
        return LM(cfg, t)
    nf = cfg.first_dense_layers
    for i in range(nf):
        add(f"first_dense.{i}",
            _init_dense_layer(gen, cfg, device, cfg.dense_d_ff or cfg.d_ff))
    if cfg.enc_dec:
        # the encoder's layers: no cross-attention, no MoE; the decoder's
        # carry cross-attention and a SwiGLU, as the reference's
        for i in range(cfg.n_enc_layers):
            add(f"encoder.{i}", _init_dense_layer(gen, cfg, device, cfg.d_ff))
        t["enc_norm"] = torch.ones(d, device=device)
        for i in range(cfg.n_layers):
            add(f"layers.{i}", _init_dense_layer(gen, cfg, device, cfg.d_ff,
                                                 cross=True))
        return LM(cfg, t)
    for i in range(cfg.n_layers - nf):
        add(f"layers.{i}", _init_dense_layer(
            gen, cfg, device, None if cfg.n_experts else cfg.d_ff))
    return LM(cfg, t)


def abstract_params(cfg: ModelConfig) -> LM:
    """The parameters' shapes and dtypes without storage: an ``LM`` on the
    ``meta`` device (the reference's ``eval_shape`` of ``init_params``)."""
    return init_params(cfg, device="meta")


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------

def _embed_inputs(p: LM, cfg: ModelConfig, batch: Dict, dtype):
    """Token embeddings; a vision config's first ``frontend_len``
    positions are its patch embeddings through the frontend instead."""
    x = p.embed[batch["tokens"].long()].to(dtype)
    if cfg.frontend == "vision":
        vis = batch["vision_embeds"].to(dtype)               # (B, Fl, Fd)
        vis = vis @ p.frontend.proj + p.frontend.bias
        x = torch.cat([vis, x[:, cfg.frontend_len:]], dim=1)
    return x


def _logits(p: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = p.embed.T if cfg.tie_embeddings else p.head
    return x @ head.to(x.dtype)


def _positions(cfg: ModelConfig, batch: Dict, b: int, s: int, device
               ) -> torch.Tensor:
    """``(B, S)`` positions; M-RoPE's ``(3, B, S)``, the temporal, height
    and width streams equal, as the reference's."""
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
    if cfg.rope_kind == "mrope":
        pos = pos[None].expand(3, b, s)
    return pos


def _dense_block(p: DenseLayer, x, cfg: ModelConfig, *, positions, cache,
                 cache_index, enc_out=None, enc_pos=None, causal=True):
    """One layer: (x, its cache, the MoE's aux losses, ``{}`` for a
    dense FFN).

    A decoder layer with cross-attention builds ``ck`` / ``cv`` from
    ``enc_out`` in a full pass (into the returned cache), and in a decode
    step attends to the cached ones at every encoder position, writing
    only its self-attention's rows (the cache it returns is that one).
    """
    self_cache, cross_kv = cache, None
    if cache is not None and "ck" in cache:
        cross_kv = (cache["ck"], cache["cv"])
        self_cache = {k: v for k, v in cache.items() if k not in ("ck", "cv")}
    with TRACER.span("model.attention", layer="model"):
        h, new_cache = attention(p.attn, rmsnorm(p.ln1, x, cfg.norm_eps),
                                 cfg, positions=positions, cache=self_cache,
                                 cache_index=cache_index, causal=causal)
    x = x + h
    if p.cross is not None and enc_out is not None:    # full pass: build kv
        with TRACER.span("model.attention", layer="model"):
            h, ckv = attention(p.cross,
                               rmsnorm(p.ln_cross, x, cfg.norm_eps), cfg,
                               positions=positions, kv_x=enc_out,
                               kv_positions=enc_pos)
        x = x + h
        new_cache = {**new_cache, **ckv}
    elif p.cross is not None and cross_kv is not None:  # decode: cached kv
        b, se = x.shape[0], cross_kv[0].shape[1]
        kv_pos = torch.arange(se, dtype=torch.int32,
                              device=x.device)[None].expand(b, se)
        with TRACER.span("model.attention", layer="model"):
            h = cross_attend(p.cross, rmsnorm(p.ln_cross, x, cfg.norm_eps),
                             cfg, cross_kv,
                             positions if positions.ndim == 2
                             else positions[0], kv_pos)
        x = x + h
    if p.moe is not None:
        with TRACER.span("model.moe", layer="model"):
            h, aux = moe_ffn(p.moe, rmsnorm(p.ln2, x, cfg.norm_eps), cfg)
    else:
        with TRACER.span("model.mlp", layer="model"):
            h, aux = mlp(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps)), {}
    return x + h, new_cache, aux


def _ssm_block(p: SSMLayer, x, cfg: ModelConfig, *, state):
    """One SSM layer: (x, its new SSM / conv state)."""
    h, new_state = ssm_layer(p.ssm, rmsnorm(p.ln1, x, cfg.norm_eps), cfg,
                             state=state)
    return x + h, new_state


#: Cache groups in layer order: the leading dense layers, then the rest.
_GROUPS = (("first_dense", "first_dense"), ("attn", "layers"))


def _stack(caches) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of plain matmuls (``aten.mm`` / ``addmm``, the reference's
    ``dots_with_no_batch_dims_saveable``), recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: bool, remat_policy: Optional[str] = None):
    """``fn`` recomputed in the backward pass instead of keeping its
    activations (the reference's ``jax.checkpoint`` of a layer body) when
    ``remat`` is set and autograd records; "dots" keeps the matmuls'
    outputs.  The values are the same either way."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def _ssm_stack(p_layers, x, cfg: ModelConfig, want_cache: bool,
               block=_ssm_block):
    """The chunked pass through a run of SSM layers: (x, their states
    stacked on a leading layer axis, or None)."""
    states = []
    for layer in p_layers:
        x, st = block(layer, x, cfg, state=None)
        if want_cache:
            states.append(st)
    return x, (_stack(states) if states else None)


def _super_block(p: LM, layers, x, cfg: ModelConfig, positions,
                 want_cache: bool):
    """One hybrid super-block: its SSM layers, then the shared block."""
    x, st = _ssm_stack(layers, x, cfg, want_cache)
    x, kv, _ = _dense_block(p.shared_attn, x, cfg, positions=positions,
                            cache=None, cache_index=None)
    return x, st, kv


def _forward_ssm(p: LM, cfg: ModelConfig, x, positions, want_cache: bool,
                 remat, pin):
    """The SSM and hybrid layer stacks of ``forward``: (x, caches).

    The hybrid's states stack as the reference's nested scan does:
    ``(n_super, attn_every, ...)`` under ``"ssm"``, the shared block's KV
    caches ``(n_super, ...)`` under ``"attn"``, the tail's under
    ``"tail"``.  ``remat`` wraps each rematerialized body (an SSM layer, a
    hybrid's super-block and tail layer) as the reference's scans do;
    ``pin`` is applied after each SSM layer and each super-block, where
    the reference pins its ``act_spec``.
    """
    caches = {}
    if cfg.family == "ssm":
        block = remat(_ssm_block)

        def pinned(*args, **kw):
            h, st = block(*args, **kw)
            return pin(h), st
        x, caches["ssm"] = _ssm_stack(p.layers, x, cfg, want_cache, pinned)
        return x, caches
    states, kvs = [], []
    super_block = remat(_super_block)
    for layers in p.layers:
        x, st, kv = super_block(p, layers, x, cfg, positions, want_cache)
        x = pin(x)
        if want_cache:
            states.append(st)
            kvs.append(kv)
    if want_cache:
        caches["ssm"], caches["attn"] = _stack(states), _stack(kvs)
    if len(p.tail):
        x, caches["tail"] = _ssm_stack(p.tail, x, cfg, want_cache,
                                       remat(_ssm_block))
    return x, caches


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------

def forward(p: LM, cfg: ModelConfig, batch: Dict, *,
            dtype=torch.bfloat16, want_cache: bool = False,
            remat: bool = True, remat_policy: Optional[str] = None,
            act_spec=None, return_hidden: bool = False):
    """Full-sequence pass.  Returns (logits, caches|None, aux).

    ``caches`` is ``{"attn": {"k": (L, B, S, KH, Dh), "v": ...}}``, the
    reference's stacked layout (MLA: ``"latent"`` and ``"k_rope"``), with
    a ``"first_dense"`` group of the same kind for a MoE config's leading
    dense layers; an SSM config's is ``{"ssm": {"ssm", "conv_x",
    "conv_bc"}}``, a hybrid's as ``_forward_ssm`` says.  ``aux`` holds the
    MoE layers' losses summed, zero for the other families.
    ``return_hidden`` skips the LM head.  ``remat`` recomputes each layer
    in the backward pass (``remat_policy="dots"`` keeps the matmuls'
    outputs), where autograd records; the encoder's layers always are, as
    the reference's.  ``act_spec`` is a function applied to the residual
    stream after the embedding and after every layer (the leading dense
    layers excepted), where the reference pins its ``act_spec``
    PartitionSpec: the dry run passes a DTensor redistribution.  The
    reference's ``unroll`` (a scan's unrolling) has no counterpart in a
    Python layer loop.
    """
    check_family(cfg)
    pin = act_spec or (lambda h: h)
    x = pin(_embed_inputs(p, cfg, batch, dtype))
    b, s, _ = x.shape
    positions = _positions(cfg, batch, b, s, x.device)
    aux = {"aux_loss": torch.zeros((), device=x.device),
           "z_loss": torch.zeros((), device=x.device)}
    enc_out = enc_pos = None
    if cfg.enc_dec:
        enc_out, enc_pos = _encode(p, cfg, batch, dtype)

    def wrap(fn):
        return _remat(fn, remat, remat_policy)
    if cfg.family in ("ssm", "hybrid"):
        x, caches = _forward_ssm(p, cfg, x, positions, want_cache, wrap,
                                 pin)
    else:
        caches = {}
        block = wrap(_dense_block)
        for group, name in _GROUPS:
            kvs = []
            for layer in getattr(p, name):
                x, kv, layer_aux = block(
                    layer, x, cfg, positions=positions, cache=None,
                    cache_index=None, enc_out=enc_out, enc_pos=enc_pos)
                if name == "layers":
                    x = pin(x)
                aux = {k: v + layer_aux.get(k, 0.0) for k, v in aux.items()}
                if want_cache:
                    kvs.append(kv)
            if kvs:
                caches[group] = _stack(kvs)
    x = rmsnorm(p.final_norm, x, cfg.norm_eps)
    caches = caches if want_cache else None
    if return_hidden:
        return x, caches, aux
    return _logits(p, cfg, x), caches, aux


def _encode(p: LM, cfg: ModelConfig, batch: Dict, dtype):
    """The encoder: the audio frontend stub on ``enc_frames`` (B, Se,
    frontend_dim), then the encoder stack unmasked (``causal=False``) at
    positions ``0..Se-1``, then ``enc_norm``.  Returns (enc_out,
    enc_pos)."""
    frames = batch["enc_frames"].to(dtype)
    h = frames @ p.frontend.proj + p.frontend.bias
    b, se, _ = h.shape
    pos = torch.arange(se, dtype=torch.int32, device=h.device)[None].expand(
        b, se)
    block = _remat(_dense_block, True)
    for layer in p.encoder:
        h, _, _ = block(layer, h, cfg, positions=pos, cache=None,
                        cache_index=None, causal=False)
    return rmsnorm(p.enc_norm, h, cfg.norm_eps), pos


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood in float32.  The gold logit is
    gathered: the reference contracts a one-hot, whose other terms add
    exact zeros, so the value is the same."""
    lf = logits.float()
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - gold


def _chunk_nll(hidden, labels, mask, head):
    """One sequence chunk's LM head and masked NLL sum."""
    return (_nll(hidden @ head, labels) * mask).sum()


def loss_fn(p: LM, cfg: ModelConfig, batch: Dict, *, dtype=torch.bfloat16,
            remat_policy: Optional[str] = None, loss_chunks: int = 0,
            remat: bool = True, act_spec=None):
    """Teacher-forced loss: (loss, metrics).

    The mean NLL of ``batch["labels"]`` over the positions ``loss_mask``
    keeps (all without one), plus the MoE layers' aux and z losses;
    metrics ``{"loss", "nll", "aux_loss", "z_loss"}``.  The weights are
    used in ``dtype`` (norms float32) through ``cast_view``, so the
    gradients reach ``p``'s own parameters.  ``loss_chunks`` > 0 runs
    the LM head and softmax over that many sequence chunks, each
    recomputed in the backward pass, so the (B, S, V) logits never exist
    at once.  ``act_spec`` is ``forward``'s.
    """
    if dtype != torch.float32:
        p = cast_view(p, dtype)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if loss_chunks:
        hidden, _, aux = forward(p, cfg, batch, dtype=dtype, remat=remat,
                                 remat_policy=remat_policy,
                                 act_spec=act_spec, return_hidden=True)
        b, s, _ = hidden.shape
        if s % loss_chunks:
            raise ValueError(f"loss_chunks {loss_chunks} must divide the "
                             f"sequence length {s}")
        c = s // loss_chunks
        if mask is None:
            mask = torch.ones((b, s), device=hidden.device)
        mask = mask.float()
        head = (p.embed.T if cfg.tie_embeddings else p.head).to(hidden.dtype)
        chunk = _remat(_chunk_nll, True)
        tot = torch.zeros((), device=hidden.device)
        cnt = torch.zeros((), device=hidden.device)
        for i in range(loss_chunks):
            sl = slice(i * c, (i + 1) * c)
            tot = tot + chunk(hidden[:, sl], labels[:, sl], mask[:, sl],
                              head)
            cnt = cnt + mask[:, sl].sum()
        nll_mean = tot / torch.clamp_min(cnt, 1.0)
    else:
        logits, _, aux = forward(p, cfg, batch, dtype=dtype, remat=remat,
                                 remat_policy=remat_policy,
                                 act_spec=act_spec)
        nll = _nll(logits, labels)
        mask = torch.ones_like(nll) if mask is None else mask.float()
        nll_mean = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    loss = nll_mean + aux["aux_loss"] + aux["z_loss"]
    return loss, {"loss": loss, "nll": nll_mean, **aux}


# --------------------------------------------------------------------------
# caches / decode
# --------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda",
                enc_len: Optional[int] = None) -> Dict:
    """Zero KV caches, ``(L, B, max_len, KH, Dh)`` per k and v (MLA:
    ``(L, B, max_len, r)`` latent and ``(L, B, max_len, rd)`` rope key),
    one group per layer group, as the reference stacks them; an
    encoder-decoder's layers also hold the cross K / V, ``ck`` / ``cv`` of
    ``(L, B, enc_len or max_len, KH, Dh)``.  SSM layers
    get their float32 states (``ssm.make_ssm_state``) stacked the same
    way: ``"ssm"`` over the layers, or for a hybrid over (super-block,
    layer), beside the shared block's ``"attn"`` per super-block and the
    tail's ``"tail"``."""
    check_family(cfg)

    def stack(tree, *n):
        return {k: torch.zeros((*n, *v.shape), dtype=v.dtype,
                               device=v.device) for k, v in tree.items()}
    if cfg.family == "ssm":
        return {"ssm": stack(make_ssm_state(cfg, batch, device),
                             cfg.n_layers)}
    if cfg.family == "hybrid":
        n_super, n_tail = divmod(cfg.n_layers, cfg.attn_every)
        state = make_ssm_state(cfg, batch, device)
        out = {"ssm": stack(state, n_super, cfg.attn_every),
               "attn": stack(make_cache(cfg, batch, max_len, dtype, device),
                             n_super)}
        if n_tail:
            out["tail"] = stack(state, n_tail)
        return out
    base = make_cache(cfg, batch, max_len, dtype, device)
    nf = cfg.first_dense_layers
    layer = base
    if cfg.enc_dec:
        shape = (batch, enc_len or max_len, cfg.n_kv_heads, cfg.head_dim)
        layer = {**base, "ck": torch.zeros(shape, dtype=dtype, device=device),
                 "cv": torch.zeros(shape, dtype=dtype, device=device)}
    out = {"attn": stack(layer, cfg.n_layers - nf)}
    if nf:
        out["first_dense"] = stack(base, nf)
    return out


def pad_caches(caches: Dict, max_len: int) -> Dict:
    """Grow prefill caches (seq = prompt len) to the serving max_len; SSM
    states have no sequence axis, and the cross K / V (``ck`` / ``cv``)
    keep the encoder's length: they pass as they are."""
    def pad(name, x):
        if name in ("k", "v", "latent", "k_rope"):
            axis = x.ndim - (3 if name in ("latent", "k_rope") else 4) + 1
            if max_len > x.shape[axis]:
                shape = list(x.shape)
                shape[axis] = max_len
                out = torch.zeros(shape, dtype=x.dtype, device=x.device)
                out.narrow(axis, 0, x.shape[axis]).copy_(x)
                return out
        return x

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else pad(k, v)
                for k, v in tree.items()}
    return walk(caches)


def _ssm_steps(p_layers, x, cfg: ModelConfig, states: Dict):
    """One recurrent step through a run of SSM layers, each layer's
    states (leaf ``[i]`` of ``states``) overwritten in place."""
    for i, layer in enumerate(p_layers):
        st = {k: c[i] for k, c in states.items()}
        x, new = _ssm_block(layer, x, cfg, state=st)
        for k, t in st.items():
            t.copy_(new[k])
    return x


def decode_step(p: LM, cfg: ModelConfig, tokens: torch.Tensor, caches: Dict,
                cache_index: int, *, dtype=torch.bfloat16):
    """One decode step.  tokens: (B, 1); cache_index: a Python int.

    The KV caches are updated in place (position ``cache_index`` of every
    layer), and so are the SSM and conv states, and returned, where the
    reference returns new ones.  An encoder-decoder's cross K / V are
    read, never written.

    Spans (profiler ranges while one records): ``model.decode_step``
    around the step, ``model.attention`` and ``model.mlp`` /
    ``model.moe`` around each dense layer's sublayers (``_dense_block``),
    ``model.head`` around the final norm and the LM head; MLA's absorbed
    attention inside ``model.mla``, and an expert share's gate, held
    experts (their kernel in ``launch.experts``) and shared experts in
    ``model.moe.route`` / ``.experts`` / ``.shared``.
    """
    check_family(cfg)
    with TRACER.span("model.decode_step", layer="model"):
        x = p.embed[tokens.long()].to(dtype)
        b = tokens.shape[0]
        pos = torch.full((b, 1), cache_index, dtype=torch.int32,
                         device=x.device)
        if cfg.rope_kind == "mrope":
            pos = pos[None].expand(3, b, 1)
        if cfg.family == "ssm":
            x = _ssm_steps(p.layers, x, cfg, caches["ssm"])
        elif cfg.family == "hybrid":
            for s, block in enumerate(p.layers):
                x = _ssm_steps(block, x, cfg,
                               {k: c[s] for k, c in caches["ssm"].items()})
                # the one shared block, each super-block's own KV cache
                x, _, _ = _dense_block(
                    p.shared_attn, x, cfg, positions=pos,
                    cache={k: c[s] for k, c in caches["attn"].items()},
                    cache_index=cache_index)
            if len(p.tail):
                x = _ssm_steps(p.tail, x, cfg, caches["tail"])
        else:
            for group, name in _GROUPS:
                for i, layer in enumerate(getattr(p, name)):
                    # each leaf [i] is a view: the layer writes its rows
                    # in place
                    x, _, _ = _dense_block(
                        layer, x, cfg, positions=pos,
                        cache={k: c[i] for k, c in caches[group].items()},
                        cache_index=cache_index)
        with TRACER.span("model.head", layer="model"):
            logits = _logits(p, cfg, rmsnorm(p.final_norm, x, cfg.norm_eps))
        return logits, caches


def prefill(p: LM, cfg: ModelConfig, batch: Dict, *, dtype=torch.bfloat16):
    """Prompt pass: last-position logits (B, 1, V) + caches.

    The LM head runs on the last position only: the reference computes
    every position's logits and keeps the last.
    """
    x, caches, _ = forward(p, cfg, batch, dtype=dtype, want_cache=True,
                           remat=False, return_hidden=True)
    return _logits(p, cfg, x[:, -1:]), caches

