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

Global cost parity: on reduced configs, every family's train, prefill
and decode steps (and a Mistral-NeMo-12B train and prefill step at four
query chunks, the chunked attention) count the reference's dot FLOPs
exactly, and its FLOPs and bytes within 1%, after the listed
differences.  Both walks go by source line: the reference's jaxpr
equations by their user frame, the port's ops by the model's frame (a
backward op by the forward line anomaly mode recorded for its node).  A
listed difference names a few lines on each side.  Its reference side
is what the reference's walk counts on its lines (the gold logit's and
the LM head's dots also held to 4 B S V and 2 B S D V).  Its port side
is held to what the port's code must count there: every listed
difference's dots, and the bytes of the lookup, the gold gather, the LM
head, the stacked caches, the chunked attention's splits and joins and
the SSM's stacked states.  The layout moves are listed by kind: the
reference's ``transpose``s, which JAX's lowering issues (an einsum's
output order, ``dot_general``'s backward), and the port's copies that
materialize a permuted view (``clone``).  ``-s`` prints every listed
difference's sizes.  The reference's walk enters the ``jit`` calls, and
counts the ``square`` primitive, that its own walker misses under JAX
0.9 (ROADMAP Queue 3).
"""
import collections
import pathlib
import re
import sys

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
REPO = pathlib.Path(__file__).resolve().parent.parent


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
# global cost parity on reduced configs
# --------------------------------------------------------------------------

B, S = 2, 32

#: The call primitives a jaxpr nests.  The reference's walker enters
#: ``pjit`` (``src/repro/core/jaxpr_cost.py:114-117``); JAX 0.9 names that
#: primitive ``jit``, so the walker counts nothing inside ``jnp.where``,
#: ``jnp.take``, ``jax.nn.silu`` or ``jax.nn.one_hot``.  The walk here
#: enters it, with the reference's own ``_jaxpr_cost`` for each equation.
_CALLS = ("custom_jvp_call", "custom_vjp_call", "custom_vjp_call_jaxpr",
          "remat", "remat2", "checkpoint", "closed_call", "core_call", "pjit",
          "named_call", "custom_gradient", "jit")


def _ref_by_line(fn, args) -> collections.Counter:
    """The reference's cost by source line and primitive: ``(metric,
    "file:line", primitive)`` for ``dots`` / ``flops`` / ``bytes``, each
    equation counted by ``jaxpr_cost._jaxpr_cost`` (scans times their
    length, a cond's branch of most FLOPs), calls entered; a line inside
    a ``jit`` call is keyed ``"jit:file:line"``.  JAX 0.9's ``square``
    primitive (``jnp.square``), which the reference's table does not
    name, counts as the ``integer_pow`` it stands for."""
    out = collections.Counter()

    def walk(jaxpr, k, in_jit):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name == "scan":
                walk(eqn.params["jaxpr"].jaxpr,
                     k * int(eqn.params["length"]), in_jit)
                continue
            if name == "while":
                walk(eqn.params["body_jaxpr"].jaxpr, k, in_jit)
                continue
            if name == "cond":
                branch = max(eqn.params["branches"],
                             key=lambda b: j_cost._jaxpr_cost(b.jaxpr).flops)
                walk(branch.jaxpr, k, in_jit)
                continue
            if name in _CALLS:
                for pname in j_cost.CALL_PARAM_NAMES:
                    if pname in eqn.params:
                        sub = eqn.params[pname]
                        walk(sub.jaxpr if hasattr(sub, "jaxpr") else sub, k,
                             in_jit or name == "jit")
                        break
                continue
            c = j_cost._jaxpr_cost(type("J", (), {"eqns": [eqn]})())
            flops = c.flops
            if name == "square":
                flops += (j_cost.ELEMENTWISE_N["integer_pow"]
                          * eqn.outvars[0].aval.size)
            fr = source_info_util.user_frame(eqn.source_info.traceback)
            line = (f"{fr.file_name.split('src/')[-1]}:{fr.start_line}"
                    if fr else "?")
            line = "jit:" + line if in_jit else line
            out["dots", line, name] += c.dot_flops * k
            out["flops", line, name] += flops * k
            out["bytes", line, name] += c.bytes * k
    walk(jax.make_jaxpr(fn)(*args).jaxpr, 1.0, False)
    return out


class _Attributed(trace_cost.CostMode):
    """``CostMode`` that keys what it counts by the op and where the
    model's code issued it: ``(metric, "file::function:line", op)``, a
    backward op by the forward line that recorded its node (anomaly
    mode's traceback); ``"?"`` outside the model (the optimizer)."""

    def __init__(self):
        super().__init__()
        self.by = collections.Counter()
        self._op = "?"

    @staticmethod
    def _where() -> str:
        f = sys._getframe(2)
        while f is not None:
            if "repro_torch/models" in f.f_code.co_filename:
                return (f"{f.f_code.co_filename.split('src/')[-1]}::"
                        f"{f.f_code.co_name}:{f.f_lineno}")
            f = f.f_back
        node = torch._C._current_autograd_node()
        if node is None:
            return "?"
        tb = node.metadata.get("traceback_") or ""
        hits = re.findall(r'File "[^"]*src/(repro_torch/models/[^"]*)", '
                          r'line (\d+), in (\w+)',
                          "".join(tb) if isinstance(tb, list) else tb)
        if not hits:
            return "?"
        file, line, func = hits[-1]
        return f"{file}::{func}:{line}"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func.overloadpacket.__name__
        return super().__torch_dispatch__(func, types, args, kwargs)

    def add(self, c):
        super().add(c)
        w = self._where()
        self.by["dots", w, self._op] += c.dot_flops * self.scale
        self.by["flops", w, self._op] += c.flops * self.scale
        self.by["bytes", w, self._op] += c.bytes * self.scale


def _port_by_line(fn, args):
    """The port's global cost, its cost by line and op, and ``fn``'s
    output."""
    mode, out = _Attributed(), []
    with torch.autograd.set_detect_anomaly(True, check_nan=False):
        total = trace_cost.counted(
            mode, lambda *a: out.append(fn(*a)) or out[0], *args)
    return total, mode.by, out[0]


def _ref_lines(file, *spans):
    """The reference's ``file``'s lines in ``spans`` (a line, or a
    ``(first, last)`` pair), inside a ``jit`` call or not."""
    lines = {n for sp in spans for n in (
        range(sp[0], sp[1] + 1) if isinstance(sp, tuple) else [sp])}

    def match(line, prim):
        line = line[4:] if line.startswith("jit:") else line
        f, _, n = line.rpartition(":")
        return f == file and n.isdigit() and int(n) in lines
    return match


def _port_lines(file, *spans):
    """The port's ``file``'s lines in ``spans``: each a text, every line
    that holds it, or a ``(first, last)`` pair of texts, the lines from
    the first that holds ``first`` to the next that holds ``last``."""
    src = (REPO / "src" / file).read_text().splitlines()
    lines = set()
    for sp in spans:
        if not isinstance(sp, tuple):
            lines |= {i + 1 for i, t in enumerate(src) if sp in t}
            continue
        i = next(i for i, t in enumerate(src) if sp[0] in t)
        j = next(j for j in range(i, len(src)) if sp[1] in src[j])
        lines |= set(range(i + 1, j + 2))

    def match(where, op):
        f, _, rest = where.partition("::")
        return f == file and int(rest.rpartition(":")[2] or 0) in lines
    return match


def _nothing(*_):
    return False


LM, ATT = "repro_torch/models/lm.py", "repro_torch/models/attention.py"
MOE_F, SSM_F = "repro_torch/models/moe.py", "repro_torch/models/ssm.py"

#: The differences each package runs its own way: ``(label, the
#: reference's lines, the port's lines)``, each side's size its own
#: walk's count there; ``_port_side`` holds what the port counts.
LAYOUT = ("the layout moves: the reference's transposes, which JAX's "
          "lowering issues (an einsum's output order, dot_general's "
          "backward, the chunked attention's axis swaps at "
          "repro/models/attention.py:112-116, 145), and the port's "
          "copies that materialize a permuted view (clone)",
          lambda line, prim: prim == "transpose",
          lambda where, op: op == "clone")
LOOKUP = ("the token lookup: the reference gathers from the float32 table "
          "(repro/models/lm.py:179, 433), the port from the table in the "
          "step's dtype",
          _ref_lines("repro/models/lm.py", 179, 433),
          _port_lines(LM, "= p.embed["))
GOLD = ("the gold logit: the reference contracts a one-hot "
        "(repro/models/lm.py:322-324, 4 B S V dots), the port gathers",
        _ref_lines("repro/models/lm.py", (322, 324)),
        _port_lines(LM, "gold = torch.gather("))
HEAD = ("the LM head over every prompt position (repro/models/lm.py:190, "
        "2 B S D V dots), the port's over the last",
        _ref_lines("repro/models/lm.py", 190),
        _port_lines(LM, "return x @ head.to(x.dtype)"))
STACK = ("the prefill's caches stacked on a layer axis: the reference's "
         "layer scan returns them stacked, with no primitive; the port "
         "stacks them (lm.py::_stack)",
         _nothing, _port_lines(LM, "return {k: torch.stack("))
FLASH = ("the chunked attention's chunks: the reference scans over the "
         "chunk axes (repro/models/attention.py:118-145), whose slices "
         "and stacked outputs are no primitive; the port splits views, "
         "whose gradients a cat joins, and cats the outputs",
         _nothing,
         _port_lines(ATT, ("ks, vs = k.split(", "kps = kv_pos.split("),
                     "in zip(q.split(q_chunk", "return torch.cat(outs"))
MOE = ("a MoE layer's one-hot dispatch and combine: the reference builds "
       "one-hot masks and contracts them (repro/models/moe.py:77-85, 90), "
       "the port scatters rows into the experts' buffers and gathers them "
       "back",
       _ref_lines("repro/models/moe.py", (77, 85), 90),
       _port_lines(MOE_F, ("n = g * e * cap", "xe = xe[:n]"),
                   ("picked = y.reshape", "out = (picked")))
SSM = ("the SSD's and the recurrent step's three-operand einsums "
       "(repro/models/ssm.py:106-111, 126-132, 173-175, 177), the port's "
       "two-operand products and its elementwise weighting",
       _ref_lines("repro/models/ssm.py", (106, 111), (126, 132), (173, 175),
                  177),
       _port_lines(SSM_F, ("wx = (xc", "bx = wx @"),
                   ("y_off = (cc[", "y_off = y_off * decay_out"),
                   ("bsum = bmat[", "bsum[:, None, None, :]"),
                   "y = (st @ csum"))
SCAN = ("the SSD's chunk states: the reference's state scan returns them "
        "stacked (repro/models/ssm.py:119-122), with no primitive; the "
        "port stacks them",
        _ref_lines("repro/models/ssm.py", (119, 122)),
        _port_lines(SSM_F, "prev_states = torch.stack("))

CASES = [(n, k, B, S) for n in sorted(j_configs.ARCHS)
         for k in ("train", "prefill", "decode")]
#: A prompt of four query chunks over two KV chunks: the chunked attention
CASES += [("mistral-nemo-12b", k, 1, 2048) for k in ("train", "prefill")]


def _listed(cfg, kind, s):
    out = [LAYOUT, LOOKUP]
    if kind == "train":
        out.append(GOLD)
    if kind == "prefill":
        out += [HEAD, STACK]
    if kind != "decode" and s > 512:
        out.append(FLASH)
    if cfg.n_experts:
        out.append(MOE)
    if cfg.family in ("ssm", "hybrid"):
        out += [SSM, SCAN]
    return out


def _ref_side(cfg, kind, b, s):
    """The reference's listed dots that are held to a formula."""
    v, d = cfg.vocab, cfg.d_model
    return {GOLD[0]: {"dots": 4.0 * b * s * v},
            HEAD[0]: {"dots": 2.0 * b * s * d * v}}


def _port_side(cfg, kind, b, s, out):
    """What the port's code must count on each listed difference's lines
    (``dots`` and ``bytes``; weights in bfloat16, ``out`` the step's
    output).  The SSM formulas are for one chunk (S = the reduced
    ``ssm_chunk``): its chunk states are the zero state, which takes no
    gradient."""
    v, d, eb = cfg.vocab, cfg.d_model, 2
    tok = b * (1 if kind == "decode" else s)
    table, idx, rows = v * d * eb, tok * 8, tok * d * eb
    sides = {
        LOOKUP[0]: {"dots": 0.0, "bytes": table + idx + rows + (
            2 * table + rows + idx if kind == "train" else 0)},
        GOLD[0]: {"dots": 0.0, "flops": b * s * v,
                  "bytes": 3 * b * s * v * 4 + 2 * b * s * 8 + 4 * b * s * 4},
        HEAD[0]: {"dots": 2.0 * b * d * v,
                  "bytes": eb * (b * d + d * v + b * v)},
        MOE[0]: {"dots": 0.0},
    }
    if kind == "prefill":
        # every cache stacked once; a hybrid's SSM states twice, in each
        # super-block and then over them (the reference's nested scan)
        caches = out[1]
        sides[STACK[0]] = {"dots": 0.0, "bytes": 2 * sum(
            t.numel() * t.element_size() for t in trace_cost.tensors_of(
                [caches, caches["ssm"] if cfg.family == "hybrid" else []]))}
    q = b * s * cfg.n_heads * cfg.head_dim * eb
    kv = b * s * cfg.n_kv_heads * cfg.head_dim * eb
    sides[FLASH[0]] = {"dots": 0.0, "bytes": cfg.n_layers * (
        2 * q if kind == "prefill" else 4 * q + 2 * (q + 2 * kv))}
    if cfg.family in ("ssm", "hybrid"):
        assert s <= cfg.ssm_chunk
        hpn = cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state
        f = 2.0 * b * s * hpn                  # one SSD product, one layer
        # train: bx twice (forward, recompute), y_off twice and its
        # gradient to c; prefill: once each; decode: y = st @ sum(c)
        per = {"train": 5 * f, "prefill": 2 * f, "decode": 2.0 * b * hpn}
        sides[SSM[0]] = {"dots": cfg.n_layers * per[kind]}
        sides[SCAN[0]] = {"dots": 0.0, "bytes": cfg.n_layers * 2 * b * hpn
                          * 4 * {"train": 2, "prefill": 1}.get(kind, 0)}
    return sides


def _steps(name, kind, b=B, s=S):
    """The reference's (fn, args) and the port's for one reduced case."""
    jcfg = j_configs.reduced(j_configs.get_arch(name))
    pcfg = p_configs.reduced(p_configs.get_arch(name))
    jcell = j_cells.Cell("t", kind, s, b)
    pcell = p_cells.Cell("t", kind, s, b)
    if kind == "train":
        opt = JAdamW()
        jp, jst = j_steps.abstract_state(jcfg, opt)
        popt = PAdamW()
        pp, pst = p_steps.abstract_state(pcfg, popt)
        return ((j_steps.make_train_step(jcfg, opt),
                 (jp, jst, j_steps.input_specs(jcfg, jcell))),
                (p_steps.make_train_step(pcfg, popt),
                 (pp, pst, p_steps.input_specs(pcfg, pcell))))
    jp, _ = j_steps.abstract_state(jcfg)
    if kind == "prefill":
        return ((j_steps.make_prefill_step(jcfg),
                 (jp, j_steps.input_specs(jcfg, jcell))),
                (p_steps.make_prefill_step(pcfg),
                 (p_lm.abstract_params(pcfg),
                  p_steps.input_specs(pcfg, pcell))))
    tok, caches, _ = p_steps.decode_input_specs(pcfg, pcell)
    return ((j_steps.make_decode_step(jcfg),
             (jp, *j_steps.decode_input_specs(jcfg, jcell))),
            (p_steps.make_decode_step(pcfg),
             (p_lm.abstract_params(pcfg), tok, caches, s - 1)))


def _split(counts, listed):
    """``counts`` by ``(metric, key, op)`` into each listed difference's
    (the first whose lines hold it) and the rest, by metric."""
    mine = {label: collections.Counter() for label, _ in listed}
    rest = collections.Counter()
    for (m, key, op), v in counts.items():
        label = next((lb for lb, pred in listed if pred(key, op)), None)
        (mine[label] if label else rest)[m] += v
    return mine, rest


@pytest.mark.parametrize("name,kind,b,s", CASES)
def test_dot_flops_equal_reference_less_listed_products(name, kind, b, s):
    """Every family's train, prefill and decode steps: the port's dot
    FLOPs equal the reference's after the listed differences, and its
    FLOPs and bytes are within 1% of the reference's walk (its ``jit``
    calls entered) after them; each listed difference's port side is
    held to what the port's code must count there."""
    (jfn, jargs), (pfn, pargs) = _steps(name, kind, b, s)
    ref = _ref_by_line(jfn, jargs)
    want = j_cost.program_cost(jfn, *jargs)
    # the walk is the reference's walker, but for what its jit calls hold
    # and its square primitives
    assert sum(v for (m, _, _), v in ref.items() if m == "dots") \
        == want["dot_flops"]
    assert sum(v for (m, k, _), v in ref.items() if m == "bytes"
               and not k.startswith("jit:")) + want["io_bytes"] \
        == want["bytes"]
    got, port, out = _port_by_line(pfn, pargs)
    assert got["io_bytes"] == pytest.approx(want["io_bytes"], abs=64)
    cfg = j_configs.reduced(j_configs.get_arch(name))
    listed = _listed(cfg, kind, s)
    ref_listed, ref_rest = _split(ref, [(lb, r) for lb, r, _ in listed])
    port_listed, port_rest = _split(
        port, [(lb, p) for lb, _, p in listed])
    ref_rest["bytes"] += want["io_bytes"]
    port_rest["bytes"] += got["io_bytes"]
    for label, _, _ in listed:
        print(f"{name} {kind} {b}x{s}: {label}: reference "
              f"{dict(ref_listed[label])}, port {dict(port_listed[label])}")
    ref_held = _ref_side(cfg, kind, b, s)
    port_held = _port_side(cfg, kind, b, s, out)
    for label, _, _ in listed:
        for m, v in ref_held.get(label, {}).items():
            assert ref_listed[label][m] == v, (label, m)
        for m, v in port_held.get(label, {}).items():
            assert port_listed[label][m] == v, (label, m)
    assert port_rest["dots"] == ref_rest["dots"]
    for m in ("flops", "bytes"):
        assert port_rest[m] == pytest.approx(ref_rest[m], rel=0.01), m
