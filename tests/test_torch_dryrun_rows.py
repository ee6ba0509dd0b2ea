"""The dry run's rows held against the reference's compiled rows.

A module fixture runs the reference's own ``lower_cell`` (compile, the
two shallow depth variants and their extrapolation) in one subprocess on
256 forced XLA host devices, with ``repro.launch.dryrun.get_arch`` and
``make_production_mesh`` swapped at run time for ``configs.reduced`` and
``make_test_mesh``: nothing of the JAX package is edited.  Two meshes:

* 4 x 4, where the reduced configs' 4 heads divide the model axis: the
  decode_32k row of every family, prefill_32k of GQA, MLA + MoE and SSM,
  train_4k of GQA;
* 16 x 16, where 4 heads over 16 is the uneven case: reduced
  Qwen1.5-32B's decode_32k and train_4k.

(MLA + MoE's and SSM's train_4k rows are not compiled here: each takes
over a minute to compile on one core; ``tests/test_torch_dryrun.py``
traces those families' train steps.)  Each port row, traced at
``hw=TPU_V5E`` so that its terms are the reference's, holds ``dominant``,
the collective bytes by kind within 10% and the arguments / output bytes
per device within 10%, each after the listed differences below; ``temp``
is printed, not held (the port's eager estimate and XLA's buffer
assignment are not the same measure).  Collective counts are not held:
XLA's combiner merges ops that DTensor issues one by one.

Listed differences:

* XLA's CPU backend reduces a bfloat16 collective in float32 (its
  ``all-reduce-promotion`` pass; the partitioned HLO before it has the
  bfloat16 all-reduces), so a reference row counts every bfloat16
  collective twice.  Every comparison adds the port's bfloat16 bytes
  (``bf16_bytes_by_kind``) once more, and
  ``test_cpu_backend_reduces_bfloat16_in_float32`` holds that factor
  exactly.
* ``LISTED``: the rows where XLA's partitioner lays a layer out otherwise
  than the port's Megatron layout, each kind's size as the port's bytes
  over the reference's (or over the reference's total, for a kind the
  reference has none of), and the reduced Qwen1.5-32B train row's padded
  heads' argument and output bytes.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.core.hw import TPU_V5E  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent

ROWS = [(arch, "decode_32k", (4, 4)) for arch in (
    "mistral-nemo-12b", "qwen1.5-32b", "deepseek-v2-lite-16b",
    "qwen3-moe-235b-a22b", "mamba2-780m", "zamba2-7b",
    "seamless-m4t-large-v2", "qwen2-vl-72b")]
ROWS += [(arch, "prefill_32k", (4, 4)) for arch in (
    "mistral-nemo-12b", "deepseek-v2-lite-16b", "mamba2-780m")]
ROWS += [("mistral-nemo-12b", "train_4k", (4, 4)),
         ("qwen1.5-32b", "decode_32k", (16, 16)),
         ("qwen1.5-32b", "train_4k", (16, 16))]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_MOE = ("XLA partitions the one-hot dispatch and combine einsums "
        "(repro/models/moe.py:82-90) with the experts split: it gathers "
        "and reduces the (G, S, E, C) masks over the model axis; the "
        "port's expert-parallel layer routes each device's tokens and "
        "reduces one partial sum")
_TRAIN = ("XLA reduces the input gradient of each column-split product on "
          "its own (q, k, v, gate, up: five a layer, and the recomputed "
          "forward's), where the port's Megatron layout sums them and "
          "reduces twice a layer")
_HEADS = ("the reference's column split puts 4 heads over a model axis of "
          "16 (a quarter head a device): XLA reshards it with all-to-alls "
          "and permutes and reduces the scores; a decode step here gathers "
          "q / k / v and runs every head on each device's batch shard "
          "(``_gathered_heads``)")
_PADDED = ("a train step here pads the 4 heads to 16, one a device "
           "(``tp_config``): the attention weights, which dominate the "
           "reduced config's, four times over (at full size, 40 to 48 "
           "heads: 1.04x)")

#: (arch, cell, mesh) -> {kind, or "arguments" / "output": (the port's
#: bytes over the reference's, or over the reference's total collectives
#: for a kind it has none of; reason)}
LISTED = {
    ("deepseek-v2-lite-16b", "decode_32k", "4x4"): {
        "all-gather": (0.0, _MOE), "all-reduce": (0.4615, _MOE)},
    ("qwen3-moe-235b-a22b", "decode_32k", "4x4"): {
        "all-gather": (0.0, _MOE), "all-reduce": (0.4737, _MOE)},
    ("deepseek-v2-lite-16b", "prefill_32k", "4x4"): {
        "all-gather": (0.0, _MOE), "all-reduce": (0.75, _MOE)},
    ("mistral-nemo-12b", "train_4k", "4x4"): {
        "all-reduce": (0.7107, _TRAIN)},
    ("qwen1.5-32b", "decode_32k", "16x16"): {
        "all-gather": (0.8, _HEADS), "all-reduce": (0.5362, _HEADS),
        "reduce-scatter": (0.0048, _HEADS), "all-to-all": (0.0, _HEADS),
        "collective-permute": (0.0, _HEADS)},
    ("qwen1.5-32b", "train_4k", "16x16"): {
        "all-reduce": (0.5133, _PADDED + "; " + _TRAIN),
        "all-to-all": (0.0, _PADDED), "collective-permute": (0.0, _PADDED),
        "arguments": (1.4264, _PADDED), "output": (1.9796, _PADDED)},
}


def _mesh_name(shape):
    return "x".join(str(n) for n in shape)


@pytest.fixture(scope="module")
def reference_rows():
    """The reference's rows of ``ROWS``, compiled in one subprocess that
    starts with the module, while the port's rows are traced: a getter by
    (arch, cell, mesh) that waits for it."""
    prog = """
import json, os, sys
from repro import configs
from repro.launch import dryrun
from repro.launch.mesh import make_test_mesh
# the reference's dry run sets 512 devices as it is imported; XLA reads
# the flag when its backend starts, at the first compile
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
out = []
for arch, cell, shape in json.loads(sys.argv[1]):
    cfg = configs.reduced(configs.get_arch(arch))
    dryrun.get_arch = lambda name, cfg=cfg: cfg
    dryrun.make_production_mesh = (
        lambda multi_pod=False, shape=tuple(shape): make_test_mesh(shape))
    _, _, meta = dryrun.lower_cell(arch, cell)
    meta["mesh"] = "x".join(map(str, shape))
    out.append(meta)
print(json.dumps(out, default=str))
"""
    proc = subprocess.Popen(
        [sys.executable, "-c", prog, json.dumps(ROWS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp"),
             "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")})
    for arch, cell, shape in ROWS:         # traced while XLA compiles
        try:
            _port_row(arch, cell, tuple(shape))
        except Exception:                  # raised again in its test
            pass
    rows = {}

    def get(arch, cell, mesh):
        if not rows:
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-4000:]
            rows.update({(r["arch"], r["cell"], r["mesh"]): r for r in
                         json.loads(out.strip().splitlines()[-1])})
        return rows[arch, cell, mesh]
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _fake_world():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _port_row(arch, cell, shape):
    _, _, row = dryrun.lower_cell(
        arch, cell, cfg=p_configs.reduced(p_configs.get_arch(arch)),
        mesh=make_test_mesh(shape), hw=TPU_V5E)
    return row


def _as_compiled_on_cpu(row):
    """The port's collective bytes by kind as the reference's CPU compile
    counts them: its bfloat16 collectives twice."""
    c = row["collectives"]
    return {k: c["bytes_by_kind"].get(k, 0)
            + c["bf16_bytes_by_kind"].get(k, 0) for k in KINDS}


@pytest.mark.parametrize("arch,cell,shape", ROWS,
                         ids=[f"{a}-{c}-{_mesh_name(s)}" for a, c, s in ROWS])
def test_row_matches_the_reference_compiled_row(reference_rows, arch, cell,
                                                shape):
    row = _port_row(arch, cell, shape)
    ref = reference_rows(arch, cell, _mesh_name(shape))
    listed = LISTED.get((arch, cell, _mesh_name(shape)), {})
    got = _as_compiled_on_cpu(row)
    want = ref["collectives"]["bytes_by_kind"]
    total = sum(want.values())
    temps = (row["bytes_per_device"]["temp"],
             ref["bytes_per_device"]["temp"])
    print(f"{arch} {cell} {_mesh_name(shape)}: temp {temps[0]} against "
          f"{temps[1]}; collectives {got} against {want}")
    for kind in KINDS:
        base = want[kind] or total
        ratio = listed.get(kind, (1.0 if want[kind] else 0.0, None))[0]
        if want[kind] or ratio:
            assert got[kind] == pytest.approx(ratio * base, rel=0.1), kind
        else:             # a kind the reference has none of: at most 1%
            assert got[kind] <= 0.01 * total, kind
    # the terms as the reference's row has them: its collectives as its CPU
    # compile counts them, and the global FLOPs and bytes over its 256
    # chips (``lower_cell`` divides by the production mesh's chips, not
    # by the test mesh's)
    scale = row["chips"] / ref["chips"]
    terms = {"compute": row["t_compute_s"] * scale,
             "memory": row["t_memory_s"] * scale,
             "collective": sum(got.values()) / TPU_V5E.link_bw}
    assert max(terms, key=terms.get) == ref["dominant"], terms
    for part in ("arguments", "output"):
        ratio = listed.get(part, (1.0, None))[0]
        assert row["bytes_per_device"][part] == pytest.approx(
            ratio * ref["bytes_per_device"][part], rel=0.1), part


@pytest.mark.parametrize("arch,cell", [("mistral-nemo-12b", "decode_32k"),
                                       ("mistral-nemo-12b", "prefill_32k")])
def test_cpu_backend_reduces_bfloat16_in_float32(reference_rows, arch, cell):
    """Where the port's collectives and XLA's are the same Megatron
    reductions, the reference's CPU compile counts the bfloat16 ones
    twice, and the float32 ones (the embedding lookup's) once: exactly."""
    row = _port_row(arch, cell, (4, 4))
    ref = reference_rows(arch, cell, "4x4")
    c = row["collectives"]
    assert c["bf16_bytes_by_kind"]["all-reduce"] > 0
    assert (2 * c["bf16_bytes_by_kind"]["all-reduce"]
            + (c["bytes_by_kind"]["all-reduce"]
               - c["bf16_bytes_by_kind"]["all-reduce"])
            == ref["collectives"]["bytes_by_kind"]["all-reduce"])


def test_serving_rows_trace_the_reference_float32_weights(reference_rows):
    """A decode row's arguments are the reference's float32 weights and
    bfloat16 caches to the byte (less the index the port passes as a
    Python int); ``--params-dtype bf16`` serves from bfloat16 ones."""
    row = _port_row("mistral-nemo-12b", "decode_32k", (4, 4))
    ref = reference_rows("mistral-nemo-12b", "decode_32k", "4x4")
    assert ref["bytes_per_device"]["arguments"] - \
        row["bytes_per_device"]["arguments"] == 4      # the int32 index
    cfg = p_configs.reduced(p_configs.get_arch("mistral-nemo-12b"))
    from repro_torch.launch.cells import CELLS
    bf16 = dryrun.trace_cell(cfg, CELLS["decode_32k"],
                             opts={"params_dtype": "bf16"},
                             mesh=make_test_mesh((4, 4)), hw=TPU_V5E)
    assert 0 < bf16["bytes_per_device"]["arguments"] < \
        row["bytes_per_device"]["arguments"]
