"""The measured mesh on the CPU: ranks of gloo against the reference's
forced host devices.

One module-scoped reference subprocess (``--xla_force_host_platform_
device_count=8`` set before JAX starts, as ``tests/test_distributed.py``
runs it) writes an ``.npz`` and a JSON for every case; the port runs the
same inputs on its ranks (``host_device_count(4)``, the plain versions):

* every family through ``MeshExecutor`` at widths 2 and 4 equals the
  reference's mesh and virtual outputs (float32 1e-4) and the port's own
  unsharded and virtual outputs bit for bit; the stencil at 3 ranks (an
  uneven, padded edge) too, and a halo wider than a rank's rows raises
  the reference's ``ValueError``;
* ``measure`` returns the reference's keys, 0 collective for a plan that
  wires no bytes and a nonzero one for the stencil's halos, a consistent
  skew; the overlap probe's products equal the reference's collective
  matmuls;
* ``rules.param_pspecs`` / ``cache_pspecs`` equal the reference's specs,
  as tuples, for every architecture's reduced tree, on no mesh, (2, 4)
  and (2, 2);
* ``reshard_restore`` restores a checkpoint the reference wrote on a
  (2, 4) mesh onto (2, 2), every rank's slices put together bit for bit;
* ``launch.train --mesh 2x4 --devices 8`` lands within the reference's
  bounds of ``--mesh 1x1`` (loss rtol 1e-5, parameters 5e-4);
* the production mesh shapes, and ``MeshExecutor(N)`` beyond the ranks
  allowed raising ``RuntimeError`` naming ``host_device_count``.

Every rank group is closed at the end; every wait in it has a timeout.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import ARCHS, get_arch, reduced  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.sharding import (MeshExecutor, ShardedExecutor,  # noqa: E402
                                  rules, traffic)
from repro_torch.sharding import ranks  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WIDTHS = (2, 4)
KERNELS = registry.names()
MESHES = {"none": None, "2x4": (2, 4), "2x2": (2, 2)}

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import ARCHS, get_arch, reduced
    from repro.kernels import registry
    from repro.launch.mesh import make_test_mesh, mesh_context
    from repro.models import lm
    from repro.runtime import checkpoint as ckpt
    from repro.sharding import MeshExecutor, ShardedExecutor, rules
    from repro.sharding.collective_matmul import (
        rowparallel_matmul, weight_gathered_matmul)

    out_dir = sys.argv[1]
    arrays, meta = {}, {"measure": {}, "specs": {}, "caches": {}}
    for width in (2, 4):
        mex, vex = MeshExecutor(width), ShardedExecutor(width)
        for name in registry.names():
            op = registry.get(name)
            args, kw = op.make_inputs(np.random.default_rng(7), op.test_size,
                                      "float32")
            arrays[f"mesh/{width}/{name}"] = np.asarray(
                mex.run(op, *args, **kw).out)
            arrays[f"virt/{width}/{name}"] = np.asarray(
                vex.run(op, *args, **kw).out)
    op = registry.get("stencil")
    args, kw = op.make_inputs(np.random.default_rng(1), 128, "float32")
    arrays["uneven/3"] = np.asarray(MeshExecutor(3).run(op, *args, **kw).out)
    for name in ("stencil", "scale"):
        op = registry.get(name)
        args, kw = op.make_inputs(np.random.default_rng(2), op.test_size,
                                  "float32")
        meta["measure"][name] = MeshExecutor(2).measure(op, *args, **kw)
    meta["probe_keys"] = sorted(MeshExecutor(4).overlap_probe())

    m4 = make_test_mesh((4,), ("model",))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    arrays["cm/x"], arrays["cm/w"] = x, w
    with mesh_context(m4):
        arrays["cm/ring"] = np.asarray(weight_gathered_matmul(
            jnp.asarray(x), jnp.asarray(w), m4, "model"))
        arrays["cm/rowparallel"] = np.asarray(rowparallel_matmul(
            jnp.asarray(x), jnp.asarray(w), m4, "model"))

    def specs(tree):
        return {jax.tree_util.keystr(p): [list(a) if isinstance(a, tuple)
                                         else a for a in s]
                for p, s in jax.tree_util.tree_leaves_with_path(
                    tree, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))}
    meshes = {"none": None, "2x4": make_test_mesh((2, 4)),
              "2x2": make_test_mesh((2, 2))}
    for name in sorted(ARCHS):
        cfg = reduced(get_arch(name))
        params = jax.eval_shape(lambda: lm.init_params(cfg,
                                                       jax.random.key(0)))
        caches = jax.eval_shape(lambda: lm.init_caches(cfg, 2, 8,
                                                       jnp.float32))
        for key, m in meshes.items():
            meta["specs"][f"{name}/{key}"] = specs(
                rules.param_pspecs(params, m))
            if m is not None:
                meta["caches"][f"{name}/{key}"] = specs(
                    rules.cache_pspecs(cfg, m, caches))

    cfg = reduced(get_arch("stablelm-12b"))
    params = lm.init_params(cfg, jax.random.key(1))
    m8 = make_test_mesh((2, 4), ("data", "model"))
    ps8 = rules.to_shardings(m8, rules.param_pspecs(params, m8))
    with mesh_context(m8):
        sharded = jax.device_put(params, ps8)
    ckpt.save(os.path.join(out_dir, "ckpt"), 3, sharded)
    for p, leaf in jax.tree_util.tree_leaves_with_path(params):
        arrays["params/" + jax.tree_util.keystr(p)] = np.asarray(leaf)
    np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
    with open(os.path.join(out_dir, "ref.json"), "w") as f:
        json.dump(meta, f)
    print("OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref")
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(out)], capture_output=True,
        text=True, timeout=600, cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp"),
             "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")})
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-4000:]
    with np.load(out / "ref.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return {"dir": out, "arrays": arrays,
            "meta": json.loads((out / "ref.json").read_text())}


@pytest.fixture(scope="module")
def pool():
    """Four ranks for the module (the plain versions, on the CPU)."""
    before = mesh_mod.host_ranks()
    mesh_mod.host_device_count(4)
    yield ranks.pool()
    ranks.close_pool()
    mesh_mod.host_device_count(before)


def _inputs(name, size=None, seed=7):
    op = registry.get(name)
    args, kw = op.make_inputs(np.random.default_rng(seed),
                              size or op.test_size, "float32", "cpu")
    return op, args, kw


# --------------------------------------------------------------------------
# MeshExecutor
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", KERNELS)
def test_every_family_matches_the_reference_mesh(ref, pool, name, width):
    op, args, kw = _inputs(name)
    run = MeshExecutor(width, backend="plain").run(op, *args, **kw)
    # the plan clamps the width to the split extent (attention: 2 heads)
    assert run.devices == run.plan.spec.num_shards <= width
    assert run.wall_s > 0
    assert run.parallel_s == run.wall_s
    got = run.out.numpy()
    for key in ("mesh", "virt"):
        want = ref["arrays"][f"{key}/{width}/{name}"]
        assert got.shape == want.shape
        err = float(np.max(np.abs(got - want)))
        assert err <= 1e-4, (name, width, key, err)
    # the unsharded plain call's and the virtual clock's output, bit for
    # bit: the mesh moves rows, never their arithmetic
    assert torch.equal(run.out, op(*args, backend="plain", **kw))
    virt = ShardedExecutor(width, backend="plain").run(op, *args, **kw).out
    assert torch.equal(run.out, virt)


def test_stencil_uneven_edge_clip(ref, pool):
    op, args, kw = _inputs("stencil", 128, seed=1)
    got = MeshExecutor(3, backend="plain").run(op, *args, **kw).out
    assert float(np.max(np.abs(got.numpy() - ref["arrays"]["uneven/3"]))) \
        <= 1e-4
    assert torch.equal(got, op(*args, backend="plain", **kw))


def test_stencil_halo_wider_than_a_rank_raises(pool):
    op, args, kw = _inputs("stencil", 8, seed=1)
    kw = dict(kw, steps=3)
    with pytest.raises(ValueError, match="exceeds the 2 rows"):
        MeshExecutor(4, backend="plain").run(op, *args, **kw)


@pytest.mark.parametrize("name,wired", [("stencil", True), ("scale", False)])
def test_measure_keys_and_invariants(ref, pool, name, wired):
    op, args, kw = _inputs(name, seed=2)
    mex = MeshExecutor(2, backend="plain")
    plan = mex.plan(op, *args, **kw)
    m = mex.measure(op, *args, plan=plan, **kw)
    assert sorted(m) == sorted(ref["meta"]["measure"][name])
    assert m["mode"] == "mesh" and m["devices"] == 2
    assert m["mesh_wall_us"] > 0 and m["virtual_us"] > 0
    wire = traffic(op, plan, args, kw)["wire_bytes"]
    if wired:
        assert wire > 0 and m["collective_us"] > 0, (wire, m)
    else:
        assert wire == 0 and m["collective_us"] == 0, (wire, m)
    expect = m["mesh_wall_us"] / m["virtual_us"]
    assert abs(m["skew"] - expect) <= 0.01 * max(expect, 1.0)


def test_overlap_probe_numerics(ref, pool):
    probe = MeshExecutor(4, backend="plain").overlap_probe(
        rows=32, contract=256, cols=64)
    assert sorted(probe) == ref["meta"]["probe_keys"]
    assert probe["devices"] == 4 and probe["shape"] == [32, 256, 64]
    for key in ("ring_us", "serialized_us", "rowparallel_us"):
        assert probe[key] > 0, (key, probe)
    assert probe["overlap_gain"] > 0


def _collective_rank(ctx, x, w):
    from repro_torch.sharding.collective_matmul import (
        gathered_matmul, rowparallel_matmul, weight_gathered_matmul)
    g = ctx.group(4)
    k = w.shape[0] // 4
    mine = slice(g.rank * k, (g.rank + 1) * k)
    return (weight_gathered_matmul(x, w[mine], g),
            rowparallel_matmul(x[:, mine], w[mine], g),
            gathered_matmul(x, w[mine], g))


def test_collective_matmuls_match_the_reference(ref, pool):
    a = ref["arrays"]
    x, w = torch.from_numpy(a["cm/x"]), torch.from_numpy(a["cm/w"])
    for ring, rowpar, gathered in pool.call(4, _collective_rank,
                                            [(x, w)] * 4):
        for got, want in ((ring, a["cm/ring"]), (rowpar, a["cm/rowparallel"]),
                          (gathered, (x @ w).numpy())):
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                       atol=2e-4)


def test_mesh_executor_needs_its_ranks(monkeypatch):
    monkeypatch.setattr(mesh_mod, "_HOST_RANKS", 1)
    with pytest.raises(RuntimeError, match="host_device_count"):
        MeshExecutor(2)
    with pytest.raises(ValueError):
        MeshExecutor(0)
    with pytest.raises(ValueError):
        mesh_mod.host_device_count(0)


def test_production_mesh_shapes():
    m1 = mesh_mod.make_production_mesh()
    assert m1.devices.size == 256 and m1.axis_names == ("data", "model")
    m2 = mesh_mod.make_production_mesh(multi_pod=True)
    assert m2.devices.size == 512
    assert m2.axis_names == ("pod", "data", "model")
    assert dict(m2.shape) == {"pod": 2, "data": 16, "model": 16}
    assert m1.group is None and m2.group is None   # no rank started
    assert mesh_mod.data_mesh(8).size == min(8, mesh_mod.host_ranks())


# --------------------------------------------------------------------------
# rules and the elastic restore
# --------------------------------------------------------------------------

def _ref_key(name: str, cfg) -> tuple:
    """A port parameter name as the reference's key path and the number
    of its stacked layer dims."""
    from repro_torch.carry import stacked_axes
    parts = name.split(".")
    n = stacked_axes(cfg).get(parts[0], 0) if len(parts) > 1 else 0
    path = [parts[0]] + parts[1 + n:]
    return "".join(f"['{p}']" for p in path), n


def _as_tuple(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_cache_specs_match_the_reference(ref, arch, mesh_key):
    cfg = reduced(get_arch(arch))
    shape = MESHES[mesh_key]
    m = None if shape is None else mesh_mod.make_test_mesh(shape)
    want = ref["meta"]["specs"][f"{arch}/{mesh_key}"]
    got = rules.param_pspecs(lm.abstract_params(cfg), m)
    for name, spec in got.items():
        key, n = _ref_key(name, cfg)
        full = _as_tuple(want[key])
        assert full[:n] == (None,) * n, (name, full)
        assert spec == full[n:], (name, spec, full)
    if m is not None:
        caches = lm.init_caches(cfg, 2, 8, torch.float32, device="meta")
        got = rules.cache_pspecs(cfg, m, caches)
        flat = {}

        def walk(node, path=""):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}['{k}']")
            else:
                flat[path] = node
        walk(got)
        assert flat == {k: _as_tuple(v) for k, v in
                        ref["meta"]["caches"][f"{arch}/{mesh_key}"].items()}


def test_reshard_restore_from_a_reference_checkpoint(ref):
    from repro_torch.runtime.elastic import (mesh_transition_plan,
                                             reshard_restore)
    cfg = reduced(get_arch("stablelm-12b"))
    template = lm.init_params(cfg, seed=5, device="cpu")
    new = mesh_mod.make_test_mesh((2, 2))
    whole, step = reshard_restore(str(ref["dir"] / "ckpt"), template, new)
    assert step == 3
    shardings = rules.to_shardings(new, rules.param_pspecs(template, new))
    parts = [reshard_restore(str(ref["dir"] / "ckpt"), template, new,
                             rank=r)[0] for r in range(new.size)]
    split = 0
    for name, t in whole.named_parameters():
        key, n = _ref_key(name, cfg)
        want = ref["arrays"]["params/" + key]
        idx = tuple(int(i) for i in name.split(".")[1:1 + n])
        want = want[idx] if n else want
        assert np.array_equal(t.detach().numpy(), want), name
        # every rank's slice sits where its sharding says, bit for bit
        sh = shardings[name]
        split += bool(sh.split_dims(t.ndim))
        rebuilt = torch.zeros_like(t)
        for r, p in enumerate(parts):
            rebuilt[sh.index(r, tuple(t.shape))] = \
                dict(p.named_parameters())[name]
        assert torch.equal(rebuilt, t), name
    assert split > 0
    plan = mesh_transition_plan({"data": 2, "model": 4},
                                {"data": 2, "model": 2})
    assert plan["tp_change"] and plan["dp_rescale"] == 1.0


# --------------------------------------------------------------------------
# the trainer on a data x model mesh
# --------------------------------------------------------------------------

def test_train_2x4_matches_1x1(tmp_path):
    from repro_torch.launch import train
    from repro_torch.runtime import checkpoint as ckpt
    before = mesh_mod.host_ranks()
    common = ["--arch", "deepseek-7b", "--reduced", "--steps", "2",
              "--batch", "8", "--seq", "16", "--device", "cpu"]
    try:
        one = train.main(common + ["--ckpt-dir", str(tmp_path / "one")])
        eight = train.main(common + ["--ckpt-dir", str(tmp_path / "eight"),
                                     "--mesh", "2x4", "--devices", "8"])
    finally:
        ranks.close_pool()
        mesh_mod.host_device_count(before)
    np.testing.assert_allclose(eight["loss"], float(one["loss"]), rtol=1e-5)
    assert len(eight["losses"]) == 2
    cfg = reduced(get_arch("deepseek-7b"))
    template = lm.init_params(cfg, seed=3, device="cpu")
    a = ckpt.restore(tmp_path / "one", (template, None), step=2)[0]
    b = ckpt.restore(tmp_path / "eight", (template, None), step=2)[0]
    d = max(float((x - y).abs().max()) for x, y in
            zip(a.parameters(), b.parameters()))
    assert d < 5e-4, d


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", KERNELS)
def test_card_mesh_outputs_are_bit_equal(card, pool, kernel):
    """Every rank on the card runs the hand-written kernel: the mesh
    output at 3 and 4 ranks equals the unsharded kernel's bit for bit,
    on both engines and every dtype."""
    op = registry.get(kernel)
    for dtype in op.dtypes:
        args, kw = op.make_inputs(np.random.default_rng(0),
                                  op.test_size or 1024, dtype, "cuda")
        for engine in ("vector", "matrix"):
            full = op(*args, engine=engine, **kw)
            for n in (3, 4):
                run = MeshExecutor(n).run(op, *args, engine=engine, **kw)
                assert torch.equal(run.out, full), (dtype, engine, n)
