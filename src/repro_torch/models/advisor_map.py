"""Per-op Eq. 2 traits for one LM decode step → the model-scale verdict.

The paper's Eq. 23/24 ceiling was verified on isolated kernels; this
module asks what fraction of a *whole decode step* that verdict governs.
Every layer op of a config's decode step (qkv/o projections, the
flash-decode attention cache scan, MLP or MoE gate+experts, the SSM
mixer, norms, embedding and LM head) gets its own
:class:`~repro_torch.core.intensity.KernelTraits` (W flops, Q bytes for one
batched single-token step), the dispatcher's memoized §6 Advice
classifies each as memory- vs compute-bound (Eq. 4), and
:func:`model_verdict` folds the per-op roofline times
(max(Q/B_mem, W/P_engine)) into time/byte fractions — the numbers the
schema-4 lm serving records carry and the ``model_verdict`` claim
re-derives.

Weight-stationary matmuls all share one shape of traits (W = 2·B·params,
Q = params·E for E-byte weights), so the per-op parameter splits reuse
the same component formulas as ``ModelConfig.param_count`` — the verdict
can never disagree with the config's own accounting.  Pure Python over
the port's ``Dispatcher`` and ``HardwareSpec``, copied from the
reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.dispatch import DEFAULT_DISPATCHER, Dispatcher
from ..core.hw import HardwareSpec
from ..core.intensity import KernelTraits
from .config import ModelConfig

__all__ = ["ModelVerdict", "OpVerdict", "decode_op_traits",
           "model_verdict", "step_traits", "verdict_payload"]


# --------------------------------------------------------------------------
# per-op parameter splits (mirrors config._count's component formulas)
# --------------------------------------------------------------------------

def _qkv_params(cfg: ModelConfig) -> int:
    """Input-side attention projections (q, k, v; MLA: q/kv down+up)."""
    d = cfg.d_model
    if cfg.use_mla:
        q = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.q_dim
             if cfg.q_lora_rank else d * cfg.q_dim)
        kv_a = d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
        kv_b = cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim
                                                 + cfg.v_head_dim)
        return q + kv_a + kv_b
    qkv = d * (cfg.q_dim + 2 * cfg.kv_dim)
    if cfg.qkv_bias:
        qkv += cfg.q_dim + 2 * cfg.kv_dim
    return qkv


def _o_params(cfg: ModelConfig) -> int:
    """Output attention projection."""
    if cfg.use_mla:
        return cfg.n_heads * cfg.v_head_dim * cfg.d_model
    return cfg.q_dim * cfg.d_model


def _ffn_params(cfg: ModelConfig, f: int) -> int:
    return 3 * cfg.d_model * f  # SwiGLU: gate, up, down


def _ssm_params(cfg: ModelConfig) -> int:
    d, di = cfg.d_model, cfg.d_inner
    n, h, g = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_ngroups
    in_proj = d * (2 * di + 2 * g * n + h)
    conv = (di + 2 * g * n) * cfg.ssm_conv
    extra = 2 * h + di
    return in_proj + conv + extra + di * d


def _attn_layers(cfg: ModelConfig) -> int:
    """Attention-block applications per decode step."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every  # shared block, reapplied
    return cfg.n_layers


# --------------------------------------------------------------------------
# the op → traits map
# --------------------------------------------------------------------------

def _matmul(name: str, batch: int, params: int, e: int,
            act_elems: int = 0) -> KernelTraits:
    """Weight-stationary matmul traits for one batched decode token.

    W = 2·B·params (one multiply-add per weight per token); Q streams
    the weights once plus the activations in/out (E bytes each).
    """
    return KernelTraits(name, 2.0 * batch * params,
                        float(params * e + batch * act_elems * e))


def decode_op_traits(cfg: ModelConfig, batch: int, cache_len: int, *,
                     dtype_bytes: int = 2,
                     cache_bytes: Optional[int] = None,
                     ) -> Dict[str, KernelTraits]:
    """Eq. 2 traits per layer op, aggregated over one decode step.

    One batched single-token step against a ``cache_len`` KV/SSM state,
    weights and activations in ``dtype_bytes``-byte precision (KV cache
    in ``cache_bytes``, default the same).  Keys are stable op names in
    execution order; values aggregate every layer's instance of that op
    (the scan reuses one block, the bytes do not).
    """
    e = int(dtype_bytes)
    ec = int(cache_bytes) if cache_bytes is not None else e
    b, s = int(batch), int(cache_len)
    d = cfg.d_model
    la = _attn_layers(cfg)
    ops: Dict[str, KernelTraits] = {}

    # one embedding row gathered per token: pure traffic, no flops
    ops["embed"] = KernelTraits("embed", 0.0, float(b * d * e))

    if la:
        ops["qkv_proj"] = _matmul("qkv_proj", b, la * _qkv_params(cfg), e,
                                  act_elems=la * (d + cfg.q_dim
                                                  + 2 * cfg.kv_dim))
        if cfg.use_mla:
            # absorbed decode scans the latent cache: score + output
            # contractions over (kv_lora_rank + qk_rope_dim) per head
            r = cfg.kv_lora_rank + cfg.qk_rope_dim
            attn = KernelTraits("attention",
                                4.0 * b * cfg.n_heads * s * r * la,
                                float(b * s * r * ec * la))
        else:
            # the registered flash-decode op's own traits formula
            # (kernels/attention/ops.py::_traits), summed over layers
            kh, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
                cfg.head_dim
            attn = KernelTraits("attention",
                                4.0 * b * kh * g * s * dh * la,
                                2.0 * b * s * kh * dh * ec * la)
        ops["attention"] = attn
        ops["o_proj"] = _matmul("o_proj", b, la * _o_params(cfg), e,
                                act_elems=la * 2 * d)

    if cfg.family in ("ssm", "hybrid"):
        # SSM mixer: projections are weight-stationary; the recurrent
        # state (h, conv windows) is read+written once per step
        state = (cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state
                 + (cfg.ssm_conv - 1) * (cfg.d_inner
                                         + 2 * cfg.ssm_ngroups
                                         * cfg.ssm_state))
        params = cfg.n_layers * _ssm_params(cfg)
        ops["ssm_mixer"] = KernelTraits(
            "ssm_mixer",
            2.0 * b * params + 6.0 * b * cfg.n_layers * cfg.d_inner
            * cfg.ssm_state,
            float(params * e + 2 * b * cfg.n_layers * state * 4))

    if cfg.family == "hybrid":
        ops["mlp"] = _matmul("mlp", b, la * _ffn_params(cfg, cfg.d_ff), e,
                             act_elems=la * 2 * d)
    elif cfg.n_experts:
        moe_layers = cfg.n_layers - cfg.first_dense_layers
        ops["moe_gate"] = _matmul("moe_gate", b,
                                  moe_layers * d * cfg.n_experts, e)
        expert = 3 * d * cfg.moe_d_ff
        active = cfg.top_k + cfg.n_shared_experts        # per token
        touched = min(b * cfg.top_k, cfg.n_experts) + cfg.n_shared_experts
        ops["moe_experts"] = KernelTraits(
            "moe_experts", 2.0 * b * moe_layers * active * expert,
            float(moe_layers * touched * expert * e + b * moe_layers
                  * 2 * d * e))
        if cfg.first_dense_layers:
            f = cfg.dense_d_ff or cfg.d_ff
            ops["mlp"] = _matmul(
                "mlp", b, cfg.first_dense_layers * _ffn_params(cfg, f), e,
                act_elems=cfg.first_dense_layers * 2 * d)
    elif cfg.family not in ("ssm",):
        ops["mlp"] = _matmul("mlp", b,
                             cfg.n_layers * _ffn_params(cfg, cfg.d_ff), e,
                             act_elems=cfg.n_layers * 2 * d)

    if cfg.enc_dec:
        # decoder cross-attention against the cached encoder K/V (the
        # encoder itself runs at prefill, not in the decode step)
        cross = cfg.n_layers * (_qkv_params(cfg) + _o_params(cfg))
        kv = b * s * cfg.kv_dim * ec * cfg.n_layers
        ops["cross_attn"] = KernelTraits(
            "cross_attn",
            2.0 * b * cross + 4.0 * b * cfg.n_heads * cfg.head_dim * s
            * cfg.n_layers,
            float(cross * e + 2 * kv))

    # rmsnorm applications: ~5 flops/element, read+write the residual
    n_norms = 1 + (2 * la if cfg.family != "hybrid" else 2 * la
                   + cfg.n_layers)
    if cfg.family == "ssm":
        n_norms = 1 + cfg.n_layers
    ops["norms"] = KernelTraits("norms", 5.0 * b * d * n_norms,
                                float((2 * b * d + d) * n_norms * e))

    # tied or not, decode reads the full (padded) vocab projection
    ops["head"] = _matmul("head", b, cfg.vocab_padded * d, e,
                          act_elems=d + cfg.vocab_padded)
    return ops


def step_traits(cfg: ModelConfig, batch: int, cache_len: int, *,
                dtype_bytes: int = 2,
                cache_bytes: Optional[int] = None) -> KernelTraits:
    """Whole-decode-step Eq. 2 traits: the per-op map, summed.

    What the serving executor's Advice (and therefore every schema-4 lm
    record's intensity/boundedness join fields) is derived from — by
    construction consistent with the per-op verdict it rides next to.
    """
    ops = decode_op_traits(cfg, batch, cache_len, dtype_bytes=dtype_bytes,
                           cache_bytes=cache_bytes)
    return KernelTraits("decode_step",
                        sum(t.work_flops for t in ops.values()),
                        sum(t.traffic_bytes for t in ops.values()))


# --------------------------------------------------------------------------
# the verdict
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpVerdict:
    """One decode-step op, classified and placed on the roofline."""

    name: str
    flops: float
    bytes: float
    intensity: float        # Eq. 2: I = W / Q
    memory_bound: bool      # Eq. 4: I < B_vector
    engine: str             # §6 Advice route ('vector'|'matrix')
    mxu_ceiling: float      # Eq. 17/23/24 matrix-engine ceiling
    time_s: float           # roofline time: max(Q/B_mem, W/P_engine)
    time_frac: float        # share of the modeled step time
    bytes_frac: float       # share of the step's bytes


@dataclasses.dataclass(frozen=True)
class ModelVerdict:
    """The paper's verdict at model scale, for one (config, B, S)."""

    model: str
    batch: int
    cache_len: int
    dtype_bytes: int
    ops: Tuple[OpVerdict, ...]
    step_time_s: float              # modeled: sum of per-op times
    memory_bound_time_frac: float   # step-time share under Eq. 23/24
    memory_bound_bytes_frac: float  # byte share moved by bound ops


def model_verdict(cfg: ModelConfig, batch: int, cache_len: int, *,
                  dtype_bytes: int = 2,
                  cache_bytes: Optional[int] = None,
                  dispatcher: Optional[Dispatcher] = None) -> ModelVerdict:
    """Classify every decode-step op and fold into the model verdict.

    Each op's traits go through the dispatcher's memoized §6 Advice
    (Eq. 4 boundedness, Eq. 17/23/24 ceiling, engine route); its
    roofline time is max(Q/B_mem, W/P) on the advisor's hardware model
    with P the routed engine's peak.  The returned fractions are what
    REPORT.md's "Verdict at model scale" table shows: how much of a
    decode step the paper's memory-bound ceiling governs.
    """
    disp = dispatcher if dispatcher is not None else DEFAULT_DISPATCHER
    hw: HardwareSpec = disp.hw
    traits = decode_op_traits(cfg, batch, cache_len,
                              dtype_bytes=dtype_bytes,
                              cache_bytes=cache_bytes)
    rows: List[Tuple[str, KernelTraits, object, float]] = []
    for name, t in traits.items():
        advice = disp.advise_traits(
            dataclasses.replace(t, name=f"{cfg.name}:{name}"))
        peak = hw.engine(advice.engine).peak_flops
        time_s = max(t.traffic_bytes / hw.mem_bw, t.work_flops / peak)
        rows.append((name, t, advice, time_s))
    total_t = sum(r[3] for r in rows) or 1.0
    total_q = sum(r[1].traffic_bytes for r in rows) or 1.0
    ops = tuple(
        OpVerdict(name=name, flops=t.work_flops, bytes=t.traffic_bytes,
                  intensity=t.intensity, memory_bound=advice.memory_bound,
                  engine=advice.engine,
                  mxu_ceiling=advice.max_speedup_matrix, time_s=time_s,
                  time_frac=time_s / total_t,
                  bytes_frac=t.traffic_bytes / total_q)
        for name, t, advice, time_s in rows)
    return ModelVerdict(
        model=cfg.name, batch=int(batch), cache_len=int(cache_len),
        dtype_bytes=int(dtype_bytes), ops=ops, step_time_s=total_t,
        memory_bound_time_frac=sum(o.time_frac for o in ops
                                   if o.memory_bound),
        memory_bound_bytes_frac=sum(o.bytes_frac for o in ops
                                    if o.memory_bound))


def verdict_payload(v: ModelVerdict, step_time_ms: float) -> Dict:
    """Shape a verdict + the *measured* mean decode-step wall time into
    the JSON block schema-4 lm records carry (``record["verdict"]``).

    Per-op ``time_ms`` distributes the measured step time by the
    modeled fractions, so the ``model_verdict`` claim can check the
    classification sums back to the measurement within tolerance.
    """
    return {
        "batch": v.batch,
        "cache_len": v.cache_len,
        "dtype_bytes": v.dtype_bytes,
        "step_time_ms": round(float(step_time_ms), 6),
        "memory_bound_time_frac": round(v.memory_bound_time_frac, 6),
        "memory_bound_bytes_frac": round(v.memory_bound_bytes_frac, 6),
        "ops": [{
            "name": o.name,
            "flops": o.flops,
            "bytes": o.bytes,
            "intensity": o.intensity,
            "memory_bound": bool(o.memory_bound),
            "engine": o.engine,
            "mxu_ceiling": o.mxu_ceiling,
            "time_frac": round(o.time_frac, 6),
            "time_ms": round(o.time_frac * float(step_time_ms), 6),
            "bytes_frac": round(o.bytes_frac, 6),
        } for o in v.ops],
    }
