"""Model configuration schema covering every assigned architecture family.

One frozen dataclass describes dense / MoE / MLA / SSM / hybrid / enc-dec /
modality-stub variants; families toggle features rather than subclassing so
`lm.py` can stay a single layer-loop implementation.  Copied from the
reference package (pure Python) so that the port imports none of it.
The settings the reference's schema lacks live in subclasses named for
the feature they carry (``ExpertShareConfig``, ``YarnRopeConfig``), so
that the copied schema stays field for field the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None   # default: d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rope_kind: str = "standard"      # standard|mrope|none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # t/h/w split of head_dim/2
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    first_dense_layers: int = 0      # leading layers with a dense FFN
    dense_d_ff: int = 0              # FFN dim of those layers
    router_aux_weight: float = 0.01

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0             # 0 = full-rank Q projection
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_ngroups: int = 1

    # --- hybrid (Zamba2): shared attention block every k SSM layers ---
    attn_every: int = 0

    # --- encoder-decoder (Seamless) ---
    enc_dec: bool = False
    n_enc_layers: int = 0

    # --- modality frontend stubs ---
    frontend: Optional[str] = None   # vision|audio
    frontend_dim: int = 0            # raw embedding dim fed by the stub
    frontend_len: int = 0            # positions consumed by the stub

    # --- decode-attention dispatch ---
    # "dense": the in-model unchunked softmax path (training parity);
    # "registry": route single-token decode attention through the
    # registered flash-decode EngineOp (kernels.attention), so the
    # dispatcher's §6 Advice picks the engine per layer and the serving
    # engine exercises the same kernel the paper's evidence tables gate.
    decode_attention_impl: str = "dense"
    # engine flag forwarded to the registry op ('auto' defers to the
    # advisor; 'vector'/'matrix' force a variant for A/B serving runs)
    decode_attention_engine: str = "auto"

    # --- capabilities ---
    sub_quadratic: bool = False      # may run the long_500k cell
    pad_vocab_to: int = 256          # Megatron-style table padding so the
                                     # vocab dim shards over any TP degree

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        m = self.pad_vocab_to
        return ((self.vocab + m - 1) // m) * m

    # ---- derived ----
    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Total parameters N (for MODEL_FLOPS = 6*N*D)."""
        return sum(int(x) for x in _count(self).values())

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k of routed experts)."""
        c = _count(self)
        total = sum(int(v) for v in c.values())
        if self.n_experts:
            routed = c["moe_routed"]
            total -= int(routed * (1 - (self.top_k / self.n_experts)))
        return total


@dataclasses.dataclass(frozen=True)
class ExpertShareConfig(ModelConfig):
    """An MoE layer that holds a share of its gate's experts, in a subclass
    so that the registered configurations keep their fields as they are.

    The layer holds ``n_experts`` of the gate's ``router_experts``, ids
    ``expert_start ..``; experts ``g * router_experts / n_groups ..`` form
    group g.  The gate (``moe.route``) is a group-limited greedy top-k:
    softmax scores over every expert, each group scored by its best
    expert, the ``topk_groups`` best groups, then the ``top_k`` best
    experts inside them (one group of all experts: a plain top-k); their
    scores times ``routed_scale`` weigh them (no renormalisation).  The layer computes its held experts' part, dropless
    (``moe.share_ffn``).
    """

    router_experts: int = 0
    expert_start: int = 0
    n_groups: int = 1
    topk_groups: int = 1
    routed_scale: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        e, g = self.router_experts, self.n_groups
        if e <= 0 or g <= 0 or e % g:
            raise ValueError(f"{self.name}: {e} routed experts do not split "
                             f"into {g} groups")
        if not 0 <= self.expert_start <= e - self.n_experts:
            raise ValueError(f"{self.name}: experts {self.expert_start}.. "
                             f"+{self.n_experts} do not lie in 0..{e - 1}")
        if not (1 <= self.topk_groups <= g and 1 <= self.top_k
                <= self.topk_groups * (e // g)):
            raise ValueError(f"{self.name}: top {self.top_k} experts in "
                             f"{self.topk_groups} of {g} groups")


@dataclasses.dataclass(frozen=True)
class YarnRopeConfig(ModelConfig):
    """MLA's rotary dims (``qk_rope_dim``) as a published checkpoint lays
    them out and scales them, in a subclass for the reason above.

    ``rope_pairs``: q_pe and k_pe come in (even, odd) pairs and are
    reordered to halves before the rotate-half rotation.  A
    ``yarn_factor`` above 1 takes YaRN: its inverse frequencies
    (``layers.yarn_frequencies``), cos and sin times the ratio of the
    ``yarn_mscale`` and ``yarn_mscale_all_dim`` factors, and the softmax
    scale times the ``yarn_mscale_all_dim`` factor squared
    (``mla_softmax_scale``).
    """

    rope_pairs: bool = False
    yarn_factor: float = 1.0
    yarn_original_len: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    @property
    def mla_softmax_scale(self) -> float:
        """The published MLA softmax scale: ``(qk_nope + qk_rope) ** -0.5``
        times the YaRN ``mscale`` squared (a Python float, as the published
        attention keeps it)."""
        m = yarn_mscale(self.yarn_factor, self.yarn_mscale_all_dim)
        return (self.qk_nope_dim + self.qk_rope_dim) ** -0.5 * m * m


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config(ExpertShareConfig, YarnRopeConfig):
    """DeepSeek-V2: an expert share under the published
    ``group_limited_greedy`` gate, and YaRN over rotary dims in (even,
    odd) pairs."""

    rope_pairs: bool = True


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 * mscale * ln(factor) + 1`` (1 for a
    factor of at most 1), as the published ``yarn_get_mscale``."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def _count(cfg: ModelConfig) -> dict:
    """Parameter counts by component (python ints, no arrays)."""
    d, v = cfg.d_model, cfg.vocab
    counts = {"embed": v * d, "head": 0 if cfg.tie_embeddings else v * d,
              "final_norm": d}
    L = cfg.n_layers

    def attn_params() -> int:
        if cfg.use_mla:
            q = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.q_dim
                 if cfg.q_lora_rank else d * cfg.q_dim)
            kv_a = d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
            kv_b = cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim
                                                     + cfg.v_head_dim)
            o = cfg.n_heads * cfg.v_head_dim * d
            return q + kv_a + kv_b + o
        qkv = d * (cfg.q_dim + 2 * cfg.kv_dim)
        if cfg.qkv_bias:
            qkv += cfg.q_dim + 2 * cfg.kv_dim
        return qkv + cfg.q_dim * d

    def ffn_params(f: int) -> int:
        return 3 * d * f  # SwiGLU: gate, up, down

    def ssm_params() -> int:
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
        g = cfg.ssm_ngroups
        in_proj = d * (2 * di + 2 * g * n + h)   # z, x, B, C, dt
        conv = (di + 2 * g * n) * cfg.ssm_conv
        extra = 2 * h + di                        # A, D, norm
        out = di * d
        return in_proj + conv + extra + out

    if cfg.family == "ssm":
        counts["ssm"] = L * ssm_params()
    elif cfg.family == "hybrid":
        counts["ssm"] = L * ssm_params()
        counts["shared_attn"] = attn_params() + ffn_params(cfg.d_ff) + 2 * d
        counts["ssm_norms"] = L * d
    elif cfg.n_experts:
        moe_layers = L - cfg.first_dense_layers
        counts["attn"] = L * attn_params()
        counts["moe_routed"] = moe_layers * cfg.n_experts * 3 * d * cfg.moe_d_ff
        if cfg.n_shared_experts:
            counts["moe_shared"] = moe_layers * 3 * d * (
                cfg.n_shared_experts * cfg.moe_d_ff)
        counts["router"] = moe_layers * d * cfg.n_experts
        if cfg.first_dense_layers:
            counts["dense_ffn"] = cfg.first_dense_layers * ffn_params(
                cfg.dense_d_ff or cfg.d_ff)
        counts["norms"] = L * 2 * d
    else:
        counts["attn"] = L * attn_params()
        counts["ffn"] = L * ffn_params(cfg.d_ff)
        counts["norms"] = L * 2 * d
        if cfg.enc_dec:
            # encoder stack + cross attention in decoder
            enc = cfg.n_enc_layers * (attn_params() + ffn_params(cfg.d_ff)
                                      + 2 * d)
            cross = cfg.n_layers * (attn_params() + d)
            counts["encoder"] = enc
            counts["cross_attn"] = cross
    if cfg.frontend:
        counts["frontend_proj"] = cfg.frontend_dim * d + d
    return counts
