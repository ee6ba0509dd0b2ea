"""The dry run, its report and ``render_perf`` against the reference's.

* Collectives: a Megatron MLP block (a column-split matmul, then a
  row-split one) with its data-parallel gradients on a (2, 4) mesh gives
  the collective bytes per kind that the reference's ``collective_stats``
  finds in the same jitted block on 8 forced host devices (a subprocess,
  as ``tests/test_distributed.py`` runs it).
* Rows: a reduced config's rows hold every field of the reference's row,
  and the ``--layout fsdp`` / ``sp`` and ``--zero1`` options trace (on a
  4 x 4 mesh, whose model axis splits the reduced configs' 4 heads); an
  op DTensor refuses makes an error row naming it; a decode step's
  collectives are the Megatron reductions, with no gather of a cache;
  heads that do not divide the model axis are padded up to it in train
  and prefill steps, gathered in decode steps.
  ``tests/test_torch_dryrun_rows.py`` holds rows against the reference's
  compiled rows.
* Tables: ``launch.report``'s three sections and
  ``bench.render_perf`` are byte-identical to the reference's on the
  same fixture rows.

The port's traces run on meta tensors over a fake process group in this
process; the module's fixture tears the group down after it.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro.launch import report as j_report  # noqa: E402

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.bench import render_perf  # noqa: E402
from repro_torch.core.analysis import collective_stats  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import report as p_report  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
META = torch.device("meta")

#: The reference's row fields (``src/repro/launch/dryrun.py:248-281``,
#: ``tag`` added by its ``main``).
REFERENCE_FIELDS = (
    "arch", "cell", "mesh", "chips", "lower_compile_s", "bytes_per_device",
    "hlo_flops", "dot_flops", "hlo_bytes", "coll_bytes_per_dev",
    "collectives", "t_compute_s", "t_memory_s", "t_collective_s",
    "dominant", "t_bound_s", "model_flops", "useful_ratio", "mfu_bound",
    "xla_cost_flops_per_dev_loops_once", "opts")


@pytest.fixture(scope="module", autouse=True)
def _fake_world():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# collectives against XLA's
# --------------------------------------------------------------------------

B, D, F = 16, 64, 256


def _reference_block_collectives() -> dict:
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import json
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from repro.core import collective_stats
        mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
        def step(x, w1, w2):
            def loss(w1, w2):
                y = jax.nn.relu(x @ w1) @ w2
                return y.sum(), y
            (_, y), (g1, g2) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(w1, w2)
            return y, g1, g2
        specs = (P("data", None), P(None, "model"), P("model", None))
        sh = tuple(NamedSharding(mesh, s) for s in specs)
        args = (jax.ShapeDtypeStruct(({B}, {D}), jnp.float32),
                jax.ShapeDtypeStruct(({D}, {F}), jnp.float32),
                jax.ShapeDtypeStruct(({F}, {D}), jnp.float32))
        hlo = jax.jit(step, in_shardings=sh, out_shardings=sh).lower(
            *args).compile().as_text()
        st = collective_stats(hlo)
        print(json.dumps({{"bytes": st.bytes_by_kind,
                           "count": st.count_by_kind}}))
    """)
    res = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True,
        timeout=600, cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp"),
             "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")})
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_megatron_block_collectives_match_xla():
    dm = dryrun.device_mesh((2, 4), ("data", "model"))
    specs = (("data", None), (None, "model"), ("model", None))
    x, w1, w2 = (dryrun.distribute(torch.empty(shape, device=META), s, dm)
                 for shape, s in zip(((B, D), (D, F), (F, D)), specs))
    w1.requires_grad_(True)
    w2.requires_grad_(True)

    def step(x, w1, w2):
        y = torch.relu(x @ w1) @ w2
        g1, g2 = torch.autograd.grad(y.sum(), (w1, w2))
        return y, g1, g2
    _, tr = dryrun.trace_sharded(step, (x, w1, w2), dm, out_specs=specs)
    got = collective_stats(tr.events)
    want = _reference_block_collectives()
    # the forward's all-reduce over "model" (B/2 x D per device) and the
    # gradients' over "data" (D x F/4 and F/4 x D): the same bytes by kind
    assert got.bytes_by_kind == want["bytes"]
    # XLA's all-reduce combiner issues the two gradients' all-reduces as
    # one tuple all-reduce, one op to its parser; DTensor issues two
    assert got.count_by_kind == {**want["count"],
                                 "all-reduce": want["count"]["all-reduce"]
                                 + 1}
    # each device's arguments are its shards: x (8, 64), w1 (64, 64) and
    # w2 (64, 64) in float32
    assert tr.arguments == 4 * (8 * D + D * F // 4 + F // 4 * D)


def test_a_rebuilt_world_forgets_the_old_meshes():
    """DTensor caches an op's sharding by its specs, whose meshes compare
    equal across worlds; a fake world rebuilt at another size (or after a
    module tore it down) must not hand back a mesh of the old one, whose
    groups no longer resolve (a train step traced after 16 x 16 rows
    failed so).  Rebuilding the world empties DTensor's caches."""
    from torch.distributed.tensor import DTensor
    dm = dryrun.device_mesh((2, 4), ("data", "model"))
    x = dryrun.distribute(torch.empty(16, 64, device=META), ("data", "model"),
                          dm)
    x * 2 + x
    stats = torch._C._get_DTensor_sharding_propagator_cache_stats
    assert stats() != (0, 0)
    dryrun.device_mesh((4, 4), ("data", "model"))
    assert stats() == (0, 0)
    prop = DTensor._op_dispatcher.sharding_propagator
    assert prop.propagate_op_sharding.cache_info().currsize == 0


# --------------------------------------------------------------------------
# rows
# --------------------------------------------------------------------------

def _reduced(name):
    return p_configs.reduced(p_configs.get_arch(name))


def _mesh(shape=(4, 4)):
    """A mesh whose model axis splits a reduced config's 4 heads."""
    from repro_torch.launch.mesh import make_test_mesh
    return make_test_mesh(shape)


@pytest.mark.parametrize("cell", ["decode_32k", "prefill_32k"])
def test_reduced_row_has_the_reference_fields(cell):
    _, _, row = dryrun.lower_cell("mistral-nemo-12b", cell,
                                  cfg=_reduced("mistral-nemo-12b"),
                                  mesh=_mesh())
    row["tag"] = None
    assert set(REFERENCE_FIELDS) <= set(row)
    assert set(row["bytes_per_device"]) == {"arguments", "output", "temp",
                                            "total_gb"}
    assert row["chips"] == 16 and row["mesh"] == "4x4"
    assert row["xla_cost_flops_per_dev_loops_once"] is None
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["t_bound_s"] == max(row["t_compute_s"], row["t_memory_s"],
                                   row["t_collective_s"])
    assert row["hw"] == "H100-SXM5"
    json.dumps(row)


def _refusing_step(cfg, **kw):
    """A decode step of the test's own whose first op is one DTensor has
    no sharding rule for (``unfold``)."""
    def step(params, tokens, caches, index):
        return tokens.unfold(1, 1, 1), caches
    return step


def test_an_op_dtensor_refuses_ends_the_trace_naming_it(monkeypatch):
    """An op DTensor refuses to shard ends the trace with an error naming
    that op; nothing reruns it on other placements."""
    monkeypatch.setattr(dryrun.steps, "make_decode_step", _refusing_step)
    with pytest.raises(dryrun.UnshardableOp, match=r"^aten\.unfold"):
        dryrun.lower_cell("mistral-nemo-12b", "decode_32k",
                          cfg=_reduced("mistral-nemo-12b"), mesh=_mesh())


def test_kv_heads_are_duplicated_up_to_the_model_axis():
    """A train or prefill step pads heads that do not divide the model
    axis up to it (Mistral-NeMo-12B's 8 KV heads to 16; Qwen1.5-32B's 40
    heads to 48); a decode step keeps them, gathers q / k / v over the
    axis (``_gathered_heads``) and keeps the reference's cache placement
    (split by sequence over the model axis), not twice its bytes: the
    reduced config's 2 KV heads over 4 hold a cache half the size of the
    one with 4 KV heads."""
    from repro_torch.launch.cells import CELLS
    cfg = p_configs.get_arch("mistral-nemo-12b")       # 32 heads, 8 KV
    padded = dryrun.tp_config(cfg, 16)
    assert (padded.n_heads, padded.n_kv_heads) == (32, 16)
    assert dryrun.tp_config(cfg, 8) is cfg
    qwen = dryrun.tp_config(p_configs.get_arch("qwen1.5-32b"), 16)
    assert (qwen.n_heads, qwen.n_kv_heads) == (48, 48)
    assert dryrun._uneven_heads(cfg, 16)
    assert not dryrun._uneven_heads(
        p_configs.get_arch("deepseek-v2-lite-16b"), 16)   # MLA: its own
    import dataclasses
    small = _reduced("mistral-nemo-12b")
    out = {}
    for kv in (4, 2):
        row = dryrun.trace_cell(dataclasses.replace(small, n_kv_heads=kv),
                                CELLS["decode_32k"], mesh=_mesh())
        out[kv] = row["bytes_per_device"]["output"]
    # a device's cache of one KV head's worth of positions: k and v in
    # bfloat16, its batch shard of 128 / 4, all 32768 positions
    head = small.n_layers * (128 // 4) * 32768 * small.head_dim * 2 * 2
    # 4 KV heads: one a device; 2: both, at a quarter of the positions
    assert out[4] - out[2] == head - 2 * head // 4


@pytest.mark.parametrize("arch,kv,cell", [
    ("mistral-nemo-12b", 2, "decode_32k"),
    ("qwen2-vl-72b", 2, "decode_32k"),
    ("deepseek-v2-lite-16b", None, "decode_32k"),
    ("zamba2-7b", None, "long_500k")],
    ids=["gqa", "vision-mrope", "mla-moe", "hybrid-long"])
def test_decode_rows_move_only_the_megatron_reductions(arch, kv, cell):
    """A decode step with its heads over the model axis (GQA, and vision
    with M-RoPE's positions, whose 2 KV heads do not divide it: q / k / v
    gathered and the cache split by sequence; MLA with a MoE layer split
    by experts; Mamba2 layers by heads, and a batch-1 attention cache
    split by sequence over the data axis) runs every device on its own shard of the caches: its
    collectives are the reductions of the row-split products and of
    split-sequence attention, and the gathers of the step's own q / k /
    v rows; none gathers a cache or a table."""
    import dataclasses
    cfg = _reduced(arch)
    if kv:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv)
    _, _, row = dryrun.lower_cell(arch, cell, cfg=cfg, mesh=_mesh())
    kinds = row["collectives"]["bytes_by_kind"]
    assert kinds["all-reduce"] > 0
    assert kinds["all-to-all"] == 0
    rows = 0                     # the gathered q / k / v rows, bfloat16
    if kv:
        rows = (cfg.n_layers * 128 // 4
                * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * 2)
    assert kinds["all-gather"] == rows
    # the caches' shards are updated in place: output bytes at least theirs
    assert row["bytes_per_device"]["output"] > 0


def test_folded_flash_counts_what_the_unfolded_loop_counts():
    """The dry run folds a prefill's query chunks (``traced_model``):
    the same dot FLOPs and bytes as the loop the model runs, and the same
    FLOPs but for the softmax scale (a 0-d sqrt and divide, 3 FLOPs)
    that the folded pass counts once per query chunk."""
    from repro_torch.core.trace_cost import program_cost
    from repro_torch.launch import steps
    from repro_torch.launch.cells import Cell
    cfg = _reduced("mistral-nemo-12b")
    cell = Cell("p", "prefill", 2048, 2)            # 4 query chunks of 512
    step = steps.make_prefill_step(cfg)
    args = (p_lm.cast_params(p_lm.abstract_params(cfg), torch.bfloat16),
            steps.input_specs(cfg, cell))
    want = program_cost(step, *args)
    with dryrun.traced_model():
        got = program_cost(step, *args)
    assert {k: v for k, v in got.items() if k != "flops"} == \
        {k: v for k, v in want.items() if k != "flops"}
    assert got["flops"] - want["flops"] == 3 * (4 - 1) * cfg.n_layers


def test_skipped_cell_gives_the_reference_reason():
    from repro import configs as j_configs
    from repro.launch.cells import CELLS as J_CELLS
    from repro.launch.cells import applicable as j_applicable
    _, _, meta = dryrun.lower_cell("mistral-nemo-12b", "long_500k")
    ok, reason = j_applicable(j_configs.get_arch("mistral-nemo-12b"),
                              J_CELLS["long_500k"])
    assert not ok and meta == {"skipped": reason}


@pytest.mark.parametrize("opts", [{"layout": "fsdp"}, {"layout": "sp"},
                                  {"zero1": True}],
                         ids=["fsdp", "sp", "zero1"])
def test_train_layouts_trace(opts):
    from repro_torch.launch.cells import Cell
    cfg = _reduced("deepseek-7b")
    row = dryrun.trace_cell(cfg, Cell("t", "train", 64, 256), opts=opts,
                            mesh=_mesh())
    assert row["opts"] == opts
    assert row["coll_bytes_per_dev"] > 0
    assert row["bytes_per_device"]["temp"] > 0


@pytest.mark.parametrize("arch", ["mamba2-780m", "deepseek-v2-lite-16b",
                                  "seamless-m4t-large-v2"])
def test_train_steps_of_the_other_families_trace(arch):
    """Mamba2 by heads, MLA and a MoE split by experts, the encoder and
    cross-attention: a train step, its backward included, traces through
    the dry run's local layers, and reduces their partial sums."""
    from repro_torch.launch.cells import Cell
    row = dryrun.trace_cell(_reduced(arch), Cell("t", "train", 64, 256),
                            mesh=_mesh())
    kinds = row["collectives"]["bytes_by_kind"]
    assert kinds["all-reduce"] > 0
    assert row["bytes_per_device"]["temp"] > 0


def test_main_writes_resumable_rows(tmp_path, capsys, monkeypatch):
    out = tmp_path / "dryrun.json"
    cfg = _reduced("deepseek-7b")
    real = dryrun.get_arch
    dryrun.get_arch = lambda name: cfg
    monkeypatch.setattr(dryrun.steps, "make_decode_step", _refusing_step)
    try:
        dryrun.main(["--arch", "deepseek-7b", "--cell", "decode_32k",
                     "--out", str(out)])
        dryrun.main(["--arch", "deepseek-7b", "--cell", "long_500k",
                     "--out", str(out)])
        dryrun.main(["--arch", "deepseek-7b", "--cell", "decode_32k",
                     "--out", str(out)])      # cached: no second trace
    finally:
        dryrun.get_arch = real
    rows = json.loads(out.read_text())
    assert [(r["arch"], r["cell"], r["mesh"]) for r in rows] == [
        ("deepseek-7b", "decode_32k", "16x16"),
        ("deepseek-7b", "long_500k", "16x16")]
    assert "skipped" in rows[1] and rows[1]["tag"] is None
    # the test's decode step runs an op DTensor refuses: an error row
    # naming it
    assert rows[0]["error"].startswith("UnshardableOp: aten.unfold")
    assert "wrote" in capsys.readouterr().out


# --------------------------------------------------------------------------
# the tables
# --------------------------------------------------------------------------

def _row(arch, cell, mesh="16x16", **kw):
    r = {"arch": arch, "cell": cell, "mesh": mesh, "chips": 256,
         "lower_compile_s": 12.5,
         "bytes_per_device": {"arguments": 3 * 2**30, "output": 2**29,
                              "temp": 7 * 2**30, "total_gb": 10.5},
         "collectives": {"bytes_by_kind": {
             "all-gather": 2**31, "all-reduce": 3 * 2**30,
             "reduce-scatter": 0, "all-to-all": 2**20,
             "collective-permute": 0}},
         "t_compute_s": 0.8, "t_memory_s": 1.7, "t_collective_s": 0.0042,
         "dominant": "memory", "t_bound_s": 1.7, "model_flops": 3.2e17,
         "useful_ratio": 0.74, "mfu_bound": 0.31}
    r.update(kw)
    return r


FIXTURE = [
    _row("qwen2-vl-72b", "train_4k"),
    _row("deepseek-v2-lite-16b", "train_4k", t_compute_s=2.5,
         dominant="compute", t_bound_s=2.5),
    _row("qwen1.5-32b", "decode_32k", t_collective_s=3.1,
         dominant="collective", t_bound_s=3.1),
    _row("qwen1.5-32b", "train_4k", mesh="2x16x16"),
    {"arch": "mistral-nemo-12b", "cell": "long_500k", "mesh": "16x16",
     "tag": None, "skipped": "full quadratic attention: 500k decode would "
     "need a sub-quadratic mechanism this arch lacks (DESIGN.md §5)"},
    {"arch": "zamba2-7b", "cell": "train_4k", "mesh": "16x16", "tag": None,
     "error": "UnshardableOp: aten.foo.default: no rule"},
]
HILLCLIMB = [
    _row("qwen2-vl-72b", "train_4k", tag="sp", t_memory_s=0.9,
         t_bound_s=0.9),
    _row("qwen1.5-32b", "decode_32k", tag="int8-kv", t_collective_s=1.2,
         t_bound_s=1.7),
]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_report_sections_equal_reference(mesh):
    rows = sorted(FIXTURE, key=lambda r: (r.get("arch", ""),
                                          r.get("cell", "")))
    assert p_report.dryrun_table(rows, mesh) == \
        j_report.dryrun_table(rows, mesh)
    assert p_report.roofline_table(rows, mesh) == \
        j_report.roofline_table(rows, mesh)
    assert p_report.summary(rows) == j_report.summary(rows)
    assert p_report.ADVICE == j_report.ADVICE


def test_report_main_prints_the_sections(tmp_path, capsys):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(FIXTURE))
    for section in ("dryrun", "roofline", "summary"):
        p_report.main(["--json", str(path), "--section", section])
        j_out = subprocess.run(
            [sys.executable, "-m", "repro.launch.report", "--json",
             str(path), "--section", section], capture_output=True,
            text=True, cwd=REPO, timeout=300,
            env={**os.environ, "PYTHONPATH": str(REPO / "src")}).stdout
        assert capsys.readouterr().out == j_out, section


def test_render_perf_equals_reference(tmp_path):
    runs = tmp_path / "runs"
    runs.mkdir()
    (runs / "dryrun.json").write_text(json.dumps(FIXTURE))
    (runs / "hillclimb.json").write_text(json.dumps(HILLCLIMB))
    want = subprocess.run(
        [sys.executable, str(REPO / "benchmarks" / "render_perf.py")],
        capture_output=True, text=True, cwd=tmp_path, timeout=300).stdout
    assert render_perf.render(FIXTURE, HILLCLIMB) == want
    got = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.render_perf", "--dryrun",
         str(runs / "dryrun.json"), "--hillclimb",
         str(runs / "hillclimb.json")], capture_output=True, text=True,
        cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}).stdout
    assert got == want
