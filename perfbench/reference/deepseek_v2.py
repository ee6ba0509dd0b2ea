"""Reference of DeepSeek-V2's decoder (an expert share of it): plain
PyTorch, float32, no cache, no kernels, no batching tricks.

It follows the published ``modeling_deepseek.py`` (DeepSeek-V2,
arXiv:2405.04434).  A layer is ``x + attn(rmsnorm(x))`` then ``x +
ffn(rmsnorm(x))``:

* attention is MLA, as the published model computes it in training and
  prefill, *not absorbed*: q through its LoRA (``wq_a``, ``q_norm``,
  ``wq_b``), the latent ``c = rmsnorm(x wkv_a[:, :r])`` decompressed
  through ``wkv_b`` into every head's ``k_nope`` and ``v``, and the
  shared rope key ``x wkv_a[:, r:]``; q_pe and k_pe are reordered from
  (even, odd) pairs to halves and rotated with YaRN's frequencies; the
  softmax scale is ``(qk_nope + qk_rope) ** -0.5`` times YaRN's mscale
  squared; causal;
* the first ``first_k_dense_replace`` layers have a SwiGLU FFN, the rest
  the MoE: softmax scores over all ``n_routed_experts_published`` experts,
  the ``group_limited_greedy`` gate (``n_group`` contiguous groups, each
  scored by its best expert, the ``topk_group`` best kept, the
  ``num_experts_per_tok`` best experts among them), weights the scores
  times ``routed_scaling_factor`` (the published ``norm_topk_prob`` is
  false: no renormalisation), ties to the lower index; plus the shared
  experts, one SwiGLU of ``n_shared_experts * moe_intermediate_size``.

Departures from the published model, each the program's as well:

* float32 throughout (published weights are bfloat16), random weights;
* the expert share: the layer holds ``n_routed_experts`` of the gate's
  experts, ids ``expert_start ..``; the gate routes over all of them, and
  only the held experts' part (with the shared experts) is added.  What
  the experts held elsewhere would add is left out;
* the stage: ``num_hidden_layers`` of the 60, with the embedding and the
  LM head on the same stage;
* the decode history is handed over as the cache holds it: each layer's
  latent rows (after ``kv_norm``) and rope-key rows (rotated, halves
  layout);
* routing near-ties (``gate``): where the reference's score of its last
  chosen candidate, a group or an expert, and of the first one it passed
  over lie within ``TIE_TOL`` of each other, it takes the program's
  choice, and counts it;
* no auxiliary loss (inference).

``forward`` runs the tokens a window served at positions after a history
of ``start`` positions, one layer at a time, decompressing the history
one sequence at a time and attending in blocks of queries, so that it
fits on the card beside nothing else.  ``precision="tf32"`` rounds every
product's operands to TF32 (the control; ``perfbench.reference``).
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

from . import no_tf32, tf32
from .dense_lm import rmsnorm

#: Relative score gap within which two routing candidates count as tied
#: (``gate``).  The program and this reference compute the same float32
#: products in other orders (absorbed against decompressed attention over
#: ~29k positions, cuBLAS at other shapes), and the difference compounds
#: over the layers: over 24 seeds at the cell's size their weights of the
#: same expert differed by at most 8.1e-5 relative (a score ratio is
#: ``exp`` of a logit difference, so that is a router-logit difference of
#: 8.1e-5).  2.5e-4 leaves three times that, and stays a quarter of the
#: TF32 control's differences (~1e-3), so that a router that is off by
#: more than rounding flips choices this band does not take.  How often
#: the band is used is itself checked (``tie_share`` in
#: ``traffic/decode_latent.py``).
TIE_TOL = 2.5e-4


class Out(NamedTuple):
    """What ``forward`` returns: the hidden states after the final norm
    (B, T, d); per layer the latent rows (B, T, r) and rope-key rows (B,
    T, rd) the tokens wrote; per MoE layer each token's experts (B, T, k)
    and weights (B, T, k); and the routing near-ties at which the program's
    choice was taken, per MoE layer."""

    hidden: object
    latent: List[object]
    k_rope: List[object]
    routes: List[object]
    gates: List[object]
    ties: List[int]


def _mm(torch, a, b, precision: str):
    if precision == "tf32":
        return tf32(torch, a) @ tf32(torch, b)
    return a @ b


def yarn_mscale(factor: float, mscale: float) -> float:
    """``0.1 mscale ln(factor) + 1`` (1 for a factor of at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(torch, cfg: dict, device):
    """The published ``DeepseekV2YarnRotaryEmbedding``'s inverse
    frequencies for the ``qk_rope_head_dim`` rotary dims."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    rs = cfg["rope_scaling"]
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]

    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** pos)
    freq_inter = 1.0 / (factor * base ** pos)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def softmax_scale(cfg: dict) -> float:
    """The published MLA softmax scale with YaRN's mscale squared."""
    rs = cfg["rope_scaling"]
    m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope(torch, x, positions, cfg: dict):
    """q_pe / k_pe (..., T, heads, rd) at ``positions`` (T,): the (even,
    odd) pairs reordered to halves, then ``x cos + rotate_half(x) sin``
    with YaRN's frequencies and cos / sin times the ratio of its two
    mscales."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(
        x.shape)
    rs = cfg["rope_scaling"]
    ms = (yarn_mscale(rs["factor"], rs["mscale"])
          / yarn_mscale(rs["factor"], rs["mscale_all_dim"]))
    freqs = torch.outer(positions.to(torch.float32),
                        yarn_inv_freq(torch, cfg, x.device))
    emb = torch.cat([freqs, freqs], -1)
    cos = (emb.cos() * ms)[:, None, :]
    sin = (emb.sin() * ms)[:, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def _select(torch, scores, cfg: dict):
    """The ``group_limited_greedy`` choice over ``scores`` (N, E): (N, k)
    expert ids, ties to the lower index."""
    n, e = scores.shape
    g = cfg["n_group"]
    groups = scores.view(n, g, e // g).amax(-1)
    gidx = torch.sort(groups, dim=-1, descending=True, stable=True)[1][
        :, :cfg["topk_group"]]
    keep = torch.zeros((n, g), dtype=torch.bool, device=scores.device)
    keep.scatter_(1, gidx, True)
    keep = keep.repeat_interleave(e // g, dim=1)
    masked = scores.masked_fill(~keep, 0.0)
    return torch.sort(masked, dim=-1, descending=True, stable=True)[1][
        :, :cfg["num_experts_per_tok"]]


def gate(torch, scores, cfg: dict, program=None):
    """(expert ids (N, k), weights (N, k), near-ties taken from the
    program) of softmax ``scores`` (N, E).

    With ``program`` (N, k), the program's ids for the same tokens, the
    reference chooses again with the program's experts' scores raised by
    a factor ``1 + TIE_TOL``: a choice that moves is one the program made
    where the reference's last chosen and first passed-over candidates lay
    within ``TIE_TOL``; everywhere else its choice is its own."""
    own = _select(torch, scores, cfg)
    ties = 0
    idx = own
    if program is not None:
        mark = torch.zeros_like(scores, dtype=torch.bool)
        mark.scatter_(1, program.long(), True)
        idx = _select(torch, torch.where(mark, scores * (1 + TIE_TOL),
                                         scores), cfg)
        same = (idx.sort(-1)[0] == own.sort(-1)[0]).all(-1)
        ties = int((~same).sum())
    return idx, scores.gather(1, idx) * cfg["routed_scaling_factor"], ties


def _swiglu(torch, x, wg, wu, wd, precision):
    return _mm(torch, torch.nn.functional.silu(_mm(torch, x, wg, precision))
               * _mm(torch, x, wu, precision), wd, precision)


def moe(torch, hs, w: dict, cfg: dict, precision: str, program=None):
    """The expert share's output for ``hs`` (N, d): the held experts'
    part and the shared experts; with the routing (ids, weights, ties)."""
    scores = torch.softmax(_mm(torch, hs, w["moe.router"], precision), -1)
    idx, gw, ties = gate(torch, scores, cfg, program)
    out = torch.zeros_like(hs)
    start = cfg["expert_start"]
    for j in range(cfg["n_routed_experts"]):
        hit = idx == start + j                                   # (N, k)
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        weight = (gw * hit).sum(-1)[rows]
        y = _swiglu(torch, hs[rows], w["moe.w_gate"][j], w["moe.w_up"][j],
                    w["moe.w_down"][j], precision)
        out.index_add_(0, rows, y * weight[:, None])
    out = out + _swiglu(torch, hs, w["moe.shared.w_gate"],
                        w["moe.shared.w_up"], w["moe.shared.w_down"],
                        precision)
    return out, idx, gw, ties


def attend(torch, q_nope, q_pe, hist_c, hist_kr, c, k_pe, w: dict,
           cfg: dict, precision: str, q_block: int = 64):
    """Causal MLA of the tokens' queries (B, T, H, nope) and (B, T, H,
    rd) over the history's latent / rope-key rows (B, S, r) / (B, S, rd)
    and the tokens' own (B, T, r) / (B, T, rd), one sequence at a time:
    the latents decompressed through ``wkv_b`` into k_nope and v.
    Returns (B, T, H * v_head_dim)."""
    b, t, h, nope = q_nope.shape
    vd = cfg["v_head_dim"]
    scale = softmax_scale(cfg)
    ctl = precision == "tf32"

    def r(x):
        return tf32(torch, x) if ctl else x
    out = torch.empty((b, t, h, vd), dtype=q_nope.dtype,
                      device=q_nope.device)
    s = hist_c.shape[1]
    for j in range(b):
        lat = torch.cat([hist_c[j], c[j]], 0)                   # (S+T, r)
        kv = _mm(torch, lat, w["attn.wkv_b"], precision).view(
            s + t, h, nope + vd)
        del lat
        k_nope = r(kv[..., :nope].permute(1, 2, 0).contiguous())  # (H,nope,L)
        v = r(kv[..., nope:].permute(1, 0, 2).contiguous())       # (H,L,vd)
        del kv
        kr = r(torch.cat([hist_kr[j], k_pe[j]], 0).t().contiguous())  # (rd,L)
        for s0 in range(0, t, q_block):
            s1 = min(t, s0 + q_block)
            qn = r(q_nope[j, s0:s1].permute(1, 0, 2))            # (H,blk,nope)
            qp = r(q_pe[j, s0:s1].permute(1, 0, 2))              # (H,blk,rd)
            sc = (qn @ k_nope + qp @ kr) * scale                 # (H,blk,L)
            qpos = torch.arange(s0, s1, device=sc.device)
            kpos = torch.arange(s + t, device=sc.device) - s
            sc = sc.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
            p = torch.softmax(sc, -1)
            del sc
            out[j, s0:s1] = (r(p) @ v).permute(1, 0, 2)
            del p
        del k_nope, v, kr
    return out.reshape(b, t, h * vd)


def forward(torch, cfg: dict, layer_fn: Callable[[int], dict], outer: dict,
            tokens, start: int, history_fn: Callable[[int], tuple],
            precision: str = "float32",
            program_routes: Optional[Callable[[int], object]] = None
            ) -> Out:
    """The tokens (B, T) at positions ``start .. start + T - 1`` after a
    history of ``start`` positions.  ``layer_fn(i)`` gives layer i's
    weights (``ln1``, ``ln2``, ``attn.wq_a`` / ``q_norm`` / ``wq_b`` /
    ``wkv_a`` / ``kv_norm`` / ``wkv_b`` / ``wo``, and ``mlp.w_gate`` ...
    or ``moe.router``, the held experts' ``moe.w_gate`` (n, d, f) ... and
    ``moe.shared.w_gate`` ...), ``history_fn(i)`` its history's latent and
    rope-key rows ((B, start, r), (B, start, rd)); ``outer`` the embedding
    and the final norm; ``program_routes(i)`` (B, T, k) the program's
    experts in MoE layer i, for the near-ties (``gate``)."""
    no_tf32(torch)
    eps = cfg["rms_norm_eps"]
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    b, t = tokens.shape
    pos = torch.arange(start, start + t, device=tokens.device)
    x = outer["embed"][tokens]
    out = Out(None, [], [], [], [], [])
    for i in range(cfg["num_hidden_layers"]):
        w = layer_fn(i)
        hs = rmsnorm(torch, x, w["ln1"], eps)
        qa = rmsnorm(torch, _mm(torch, hs, w["attn.wq_a"], precision),
                     w["attn.q_norm"], eps)
        q = _mm(torch, qa, w["attn.wq_b"], precision).view(b, t, h, nope + rd)
        kv_a = _mm(torch, hs, w["attn.wkv_a"], precision)
        c = rmsnorm(torch, kv_a[..., :r], w["attn.kv_norm"], eps)
        k_pe = rope(torch, kv_a[..., r:][:, :, None, :], pos, cfg)[:, :, 0]
        q_pe = rope(torch, q[..., nope:], pos, cfg)
        out.latent.append(c)
        out.k_rope.append(k_pe)
        hc, hkr = history_fn(i)
        a = attend(torch, q[..., :nope], q_pe, hc, hkr, c, k_pe, w, cfg,
                   precision)
        del hc, hkr
        x = x + _mm(torch, a, w["attn.wo"], precision)
        hs = rmsnorm(torch, x, w["ln2"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + _swiglu(torch, hs, w["mlp.w_gate"], w["mlp.w_up"],
                            w["mlp.w_down"], precision)
        else:
            prog = program_routes(i) if program_routes is not None else None
            y, idx, gw, ties = moe(
                torch, hs.reshape(b * t, -1), w, cfg, precision,
                None if prog is None else prog.reshape(b * t, -1))
            x = x + y.view(b, t, -1)
            out.routes.append(idx.view(b, t, -1))
            out.gates.append(gw.view(b, t, -1))
            out.ties.append(ties)
        del w, hs, q, qa, kv_a, a
    return out._replace(hidden=rmsnorm(torch, x, outer["final_norm"], eps))


def logits(torch, hidden, head, precision: str = "float32"):
    """The LM head: ``hidden @ head`` (float32)."""
    no_tf32(torch)
    return _mm(torch, hidden, head, precision)
