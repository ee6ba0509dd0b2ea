"""The cost walker and the roofline terms against the reference's.

Twins of ``tests/test_analysis.py``'s seven cases:
* the reference pins XLA's undercount of a scan body; the port's layers
  are a Python loop, counted layer by layer: an L-layer loop counts L
  times one layer (L = 1, 4, 16), and a loop folded under
  ``trace_cost.repeated`` (the port's form of the reference's ``length *
  cost(body)``) counts what the unfolded loop counts;
* grad is 3x the forward within 1%, and remat counts at least grad;
* the collective events give the byte totals of the reference's HLO
  parser test, and a ``wait_tensor`` is not counted;
* a GQA einsum counts 2 B KH G Sq Skv Dh.

Dot-flop parity: on reduced configs, the port's train, prefill and
decode steps count the reference's ``program_cost(...)["dot_flops"]``
less the products only the reference computes, each listed by name:
* the gold logit's one-hot contraction (train: forward and backward,
  4 B S V), where the port gathers;
* the LM head over every prompt position (prefill: 2 B (S - 1) D V),
  where the port runs it on the last;
* a MoE layer's one-hot dispatch and combine contractions
  (``src/repro/models/moe.py:82, 85, 90``, their sizes read from the
  reference's own jaxpr), where the port scatters and gathers rows.
The SSM and hybrid families and a MoE config's train step also differ in
how each package contracts its three-operand einsums and the one-hot's
backward; those are not accounted here (ROADMAP Queue 3).
"""
import collections

import jax
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from jax._src import source_info_util  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core import collective_stats as j_collective_stats  # noqa: E402
from repro.core import jaxpr_cost as j_cost  # noqa: E402
from repro.launch import cells as j_cells  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.core import analysis, trace_cost  # noqa: E402
from repro_torch.core.hw import (H100_SXM, PLATFORMS, TPU_V5E,  # noqa: E402
                                 dense_peak)
from repro_torch.launch import cells as p_cells  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.optim.adamw import AdamW as PAdamW  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

META = torch.device("meta")


def _meta(*shape):
    return torch.empty(shape, device=META)


# --------------------------------------------------------------------------
# the twins of tests/test_analysis.py
# --------------------------------------------------------------------------

def _matmul_chain(L, D=256, B=64):
    def f(x, ws):
        for w in ws:               # a Python layer loop
            x = x @ w
        return x
    return f, _meta(B, D), [_meta(D, D) for _ in range(L)], 2.0 * B * D * D * L


def test_folded_loop_counts_what_the_unfolded_loop_counts():
    """Where the reference pins XLA's scan undercount: the port folds a
    loop of identical chunks under ``repeated`` and counts it n times."""
    f, x, ws, expected = _matmul_chain(16)

    def folded(x, ws):
        n = len(ws) // (len(ws) if trace_cost.folding() else 1)
        with trace_cost.repeated(len(ws) // n):
            for w in ws[:n]:
                x = x @ w
        return x
    with torch.no_grad():
        got = trace_cost.program_cost(folded, x, ws)
        want = trace_cost.program_cost(f, x, ws)
    assert got["dot_flops"] == want["dot_flops"] == pytest.approx(expected)
    assert got["flops"] == want["flops"]


@pytest.mark.parametrize("L", [1, 4, 16])
def test_layer_loop_counts_each_layer(L):
    f, x, ws, expected = _matmul_chain(L)
    got = trace_cost.program_cost(f, x, ws)
    assert got["dot_flops"] == pytest.approx(expected)
    assert got["dot_flops"] == pytest.approx(
        L * trace_cost.program_cost(f, x, ws[:1])["dot_flops"])


def test_cost_counts_grad_and_remat():
    """The backward of a linear layer adds ~2x the dot flops; remat adds
    the recomputed forward again."""
    from torch.utils.checkpoint import checkpoint
    D, B = 128, 32
    w = _meta(D, D).requires_grad_(True)
    x = _meta(B, D).requires_grad_(True)

    def loss(w, x):
        return torch.tanh(x @ w).sum()
    fwd = trace_cost.program_cost(loss, w, x)["dot_flops"]
    grad = trace_cost.program_cost(
        lambda w, x: torch.autograd.grad(loss(w, x), (w, x)), w, x)[
            "dot_flops"]
    assert grad == pytest.approx(3 * fwd, rel=0.01)

    def loss_remat(w, x):
        return checkpoint(lambda xx: torch.tanh(xx @ w), x,
                          use_reentrant=False).sum()
    grad_remat = trace_cost.program_cost(
        lambda w, x: torch.autograd.grad(loss_remat(w, x), (w, x)), w, x)[
            "dot_flops"]
    assert grad_remat >= grad


def test_collective_events():
    """``tests/test_analysis.py::test_collective_parser``'s byte totals,
    from events in place of HLO text."""
    hlo = """
  %ag = f32[16,128]{1,0} all-gather(f32[2,128]{1,0} %x), replica_groups={}
  %ar = bf16[1024]{0} all-reduce(bf16[1024]{0} %y), to_apply=%sum
  %rs = f32[4,32]{1,0} reduce-scatter(f32[4,256]{1,0} %z), dimensions={1}
  %a2a = f32[8,8]{1,0} all-to-all(f32[8,8]{1,0} %t), dimensions={0}
  %agd = f32[2,2]{1,0} all-gather-done(f32[2,2] %h)
"""
    events = [("_c10d_functional.all_gather_into_tensor", 16 * 128 * 4),
              ("all_reduce", 1024 * 2),
              ("reduce_scatter_tensor", 4 * 32 * 4),
              ("all_to_all_single", 8 * 8 * 4),
              ("wait_tensor", 2 * 2 * 4)]
    st = analysis.collective_stats(events)
    ref = j_collective_stats(hlo)
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"):
        assert st.bytes_by_kind[kind] == ref.bytes_by_kind[kind], kind
        assert st.count_by_kind[kind] == ref.count_by_kind[kind], kind
    assert st.bytes_by_kind["all-reduce"] == 1024 * 2 * 2  # 2x ring
    assert st.count_by_kind["all-gather"] == 1   # wait_tensor not counted
    with pytest.raises(ValueError, match="not a functional collective"):
        analysis.collective_stats([("broadcast", 8)])


def test_cost_einsum_gqa_shape():
    """GQA einsum flops match the analytic 2*B*KH*G*Sq*Skv*Dh."""
    b, sq, skv, kh, g, dh = 2, 16, 32, 4, 2, 8
    got = trace_cost.program_cost(
        lambda q, k: torch.einsum("bqhgd,bkhd->bhgqk", q, k),
        _meta(b, sq, kh, g, dh), _meta(b, skv, kh, dh))["dot_flops"]
    assert got == pytest.approx(2 * b * kh * g * sq * skv * dh)


#: Each platform's dense bfloat16 / float32 peak, from its datasheet
#: (NVIDIA's A100, GH200 and H100 ones; v5e the reference's MXU).
DATASHEET = {"a100": (312e12, 19.5e12), "gh200": (989e12, 67e12),
             "h100": (989e12, 67e12), "h100pcie": (756e12, 51e12),
             "h100nvl": (835e12, 60e12), "v5e": (197e12, None)}


@pytest.mark.parametrize("key", sorted(PLATFORMS))
def test_dense_peak_of_every_platform(key):
    """Every platform has its datasheet's dense peak, never the FP64
    matrix engine's, and a dtype without a figure raises."""
    hw = PLATFORMS[key]
    bf16, fp32 = DATASHEET[key]
    assert dense_peak(hw, "bfloat16") == bf16
    if fp32 is None:
        with pytest.raises(KeyError):
            dense_peak(hw, "float32")
    else:
        assert dense_peak(hw, "float32") == fp32
        assert dense_peak(hw) != hw.matrix.peak_flops     # FP64's
    with pytest.raises(KeyError):
        dense_peak(hw, "int4")


def test_analyze_divides_by_the_given_spec():
    """The terms and ``mfu_bound`` at the spec's dense peak and dtype; the
    reference's ``analyze`` on the same numbers at v5e."""
    from repro.core import analyze as j_analyze
    cost = {"flops": 4e15, "bytes": 2e12}
    events = [("all_reduce", 1 << 30)]
    r = analysis.analyze("x", cost, events, 256, hw=H100_SXM,
                         model_flops=3e15, per_device_cost=False)
    assert r.t_compute == pytest.approx(4e15 / (256 * 989e12))
    assert r.t_memory == pytest.approx(2e12 / (256 * 3.35e12))
    assert r.t_collective == pytest.approx(2 * (1 << 30) / H100_SXM.link_bw)
    assert r.mfu_bound == pytest.approx(3e15 / (r.t_bound * 256 * 989e12))
    assert dense_peak(H100_SXM, "float32") == 67e12
    assert dense_peak(TPU_V5E) == TPU_V5E.matrix.peak_flops
    hlo = "  %ar = bf16[536870912]{0} all-reduce(bf16[536870912]{0} %y)\n"
    j = j_analyze("x", {"flops": 4e15 / 256, "bytes accessed": 2e12 / 256},
                  hlo, 256, model_flops=3e15)
    p = analysis.analyze("x", {"flops": 4e15 / 256,
                               "bytes accessed": 2e12 / 256},
                         events, 256, hw=TPU_V5E, model_flops=3e15)
    pr, jr = p.row(), j.row()
    assert sorted(pr) == sorted(jr)
    for k, v in jr.items():
        assert pr[k] == (v if isinstance(v, str) else pytest.approx(v)), k


# --------------------------------------------------------------------------
# dot-flop parity on reduced configs
# --------------------------------------------------------------------------

B, S = 2, 32


def _ref_dots_by_line(fn, args) -> collections.Counter:
    """The reference's dot flops by the source line that issued each
    dot_general (``jaxpr_cost``'s walk: scans times their length)."""
    out = collections.Counter()

    def walk(jaxpr, k):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name == "dot_general":
                fr = source_info_util.user_frame(eqn.source_info.traceback)
                key = (f"{fr.file_name.split('src/')[-1]}:{fr.start_line}"
                       if fr else "?")
                out[key] += j_cost._dot_cost(eqn).dot_flops * k
            elif name == "scan":
                walk(eqn.params["jaxpr"].jaxpr, k * int(eqn.params["length"]))
            elif name == "while":
                walk(eqn.params["body_jaxpr"].jaxpr, k)
            else:
                for pname in j_cost.CALL_PARAM_NAMES:
                    if pname in eqn.params:
                        sub = eqn.params[pname]
                        walk(sub.jaxpr if hasattr(sub, "jaxpr") else sub, k)
                        break
    walk(jax.make_jaxpr(fn)(*args).jaxpr, 1.0)
    return out


#: The MoE's one-hot contractions only the reference runs.
MOE_ONE_HOT = ("repro/models/moe.py:82", "repro/models/moe.py:85",
               "repro/models/moe.py:90")

DENSE = [n for n in sorted(j_configs.ARCHS)
         if j_configs.get_arch(n).family not in ("ssm", "hybrid")]
CASES = [(n, k) for n in DENSE for k in ("train", "prefill", "decode")
         if not (k == "train" and j_configs.get_arch(n).n_experts)]


@pytest.mark.parametrize("name,kind", CASES)
def test_dot_flops_equal_reference_less_listed_products(name, kind):
    jcfg = j_configs.reduced(j_configs.get_arch(name))
    pcfg = p_configs.reduced(p_configs.get_arch(name))
    jcell = j_cells.Cell("t", kind, S, B)
    pcell = p_cells.Cell("t", kind, S, B)
    if kind == "train":
        opt = JAdamW()
        jp, jst = j_steps.abstract_state(jcfg, opt)
        jfn, jargs = (j_steps.make_train_step(jcfg, opt),
                      (jp, jst, j_steps.input_specs(jcfg, jcell)))
        popt = PAdamW()
        pp, pst = p_steps.abstract_state(pcfg, popt)
        got = trace_cost.program_cost(p_steps.make_train_step(pcfg, popt),
                                      pp, pst,
                                      p_steps.input_specs(pcfg, pcell))
    elif kind == "prefill":
        jp, _ = j_steps.abstract_state(jcfg)
        jfn, jargs = (j_steps.make_prefill_step(jcfg),
                      (jp, j_steps.input_specs(jcfg, jcell)))
        got = trace_cost.program_cost(p_steps.make_prefill_step(pcfg),
                                      p_lm.abstract_params(pcfg),
                                      p_steps.input_specs(pcfg, pcell))
    else:
        jp, _ = j_steps.abstract_state(jcfg)
        jfn, jargs = (j_steps.make_decode_step(jcfg),
                      (jp, *j_steps.decode_input_specs(jcfg, jcell)))
        tok, caches, _ = p_steps.decode_input_specs(pcfg, pcell)
        got = trace_cost.program_cost(p_steps.make_decode_step(pcfg),
                                      p_lm.abstract_params(pcfg), tok,
                                      caches, S - 1)
    want = j_cost.program_cost(jfn, *jargs)["dot_flops"]
    by_line = _ref_dots_by_line(jfn, jargs)
    assert sum(by_line.values()) == want
    listed = {}
    if kind == "train":
        listed["gold one-hot contraction"] = 4.0 * B * S * jcfg.vocab
    if kind == "prefill":
        listed["LM head over every prompt position"] = \
            2.0 * B * (S - 1) * jcfg.d_model * jcfg.vocab
    if jcfg.n_experts:
        listed["MoE one-hot dispatch and combine"] = sum(
            by_line[line] for line in MOE_ONE_HOT)
    assert got["dot_flops"] + sum(listed.values()) == want, listed
