"""The port's sharding layer (``repro_torch.sharding``) against the
reference's ``repro.sharding``.

* **Plans are pure data and the reference's**: for every family at
  n in {1, 2, 3}, the port's plan JSON and ``traffic`` equal the
  reference's ``plan_for`` / ``traffic`` on the same seeded numpy inputs;
  ShardSpec / ShardPlan JSON round-trips, extent partitioning,
  ``num_shards`` clamping and halo edge clipping as in the reference's
  tests.
* **Sharding is exact**: every family's sharded plain output equals the
  unsharded plain output bit for bit, on both engines (the stencil
  *because of* its Eq. 13 halo rows: a halo-less split is shown wrong),
  and the head-split plain attention stays bit-equal at the models'
  decode shapes.  A head shard carries the unsharded call's ``B * KH`` so
  the card's split-S schedule matches; ``shard_call`` hands the kernels
  contiguous, aligned tensors.
* **Dispatch, tuning, claims, report, sweep and serving**: ``set_mesh``
  attaches the reference's ShardSpec to Advice (the "mesh" mode labels
  it), per-shard tuning entries never inherit the
  full-width tile, the shard claims give the reference's verdicts on its
  schema-5 records, the sharded section renders, ``kernels --mesh 3
  --device cpu`` writes records that pass every claim and the gate, and a
  2-way serving session records its width.
* On the card (``gpu``): every family's mesh-3 and mesh-4 outputs equal
  the unsharded kernel's bit for bit, K4's head shards included.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro import sharding as j_sharding  # noqa: E402
from repro.core.dispatch import Dispatcher as JDispatcher  # noqa: E402
from repro.kernels import registry as j_registry  # noqa: E402
from repro.report import check_records as j_check_records  # noqa: E402
from repro.report import load_dir as j_load_dir  # noqa: E402

from repro_torch.carry import cast  # noqa: E402
from repro_torch.core.dispatch import Dispatcher, TuningPolicy  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.report import (SHARD_CLAIMS, check_records,  # noqa: E402
                                load_dir, load_file, render_report,
                                violations)
from repro_torch.sharding import (SHARD_KINDS, ShardPlan,  # noqa: E402
                                  ShardSpec, ShardedExecutor,
                                  combine_outputs, plan_for, shard_call,
                                  spec_for, traffic)
from repro_torch.sharding.plan import Shard  # noqa: E402

KERNELS = registry.names()
ENGINES = ("vector", "matrix")


def _inputs(name, size=None, seed=0, device="cpu"):
    op = registry.get(name)
    size = size or op.test_size or 1024
    return op, *op.make_inputs(np.random.default_rng(seed), size,
                               "float32", device)


def _j_inputs(name, size=None, seed=0):
    op = j_registry.get(name)
    size = size or op.test_size or 1024
    return op, *op.make_inputs(np.random.default_rng(seed), size, "float32")


# --------------------------------------------------------------------------
# plans: pure data, the reference's
# --------------------------------------------------------------------------

def test_shard_spec_round_trip():
    spec = ShardSpec(kind="rowblock", num_shards=3, axis="data", halo=2)
    assert ShardSpec.from_json(spec.to_json()) == spec
    assert spec.to_json() == j_sharding.ShardSpec(
        kind="rowblock", num_shards=3, axis="data", halo=2).to_json()


def test_shard_spec_rejects_nonsense():
    with pytest.raises(ValueError):
        ShardSpec(kind="diagonal", num_shards=2)
    with pytest.raises(ValueError):
        ShardSpec(kind="data", num_shards=0)
    with pytest.raises(ValueError):
        ShardSpec(kind="data", num_shards=2, halo=-1)
    assert SHARD_KINDS == j_sharding.SHARD_KINDS


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_shard_plan_round_trip(kernel, n):
    op, args, kw = _inputs(kernel)
    plan = plan_for(op, n, *args, **kw)
    assert ShardPlan.from_json(plan.to_json()) == plan


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_plan_and_traffic_match_reference(kernel, n):
    op, args, kw = _inputs(kernel)
    jop, jargs, jkw = _j_inputs(kernel)
    plan = plan_for(op, n, *args, **kw)
    jplan = j_sharding.plan_for(jop, n, *jargs, **jkw)
    assert plan.to_json() == jplan.to_json()
    assert traffic(op, plan, args, kw) == \
        j_sharding.traffic(jop, jplan, jargs, jkw)
    assert spec_for(op, n, *args, **kw).to_json() == \
        j_sharding.spec_for(jop, n, *jargs, **jkw).to_json()


def test_plan_partitions_extent_exactly():
    op, args, kw = _inputs("scale", 1000)  # not divisible by 3
    plan = plan_for(op, 3, *args, **kw)
    assert plan.extent == 1000
    assert [s.owned for s in plan.shards] == [334, 333, 333]
    assert plan.shards[0].start == 0 and plan.shards[-1].stop == 1000
    for a, b in zip(plan.shards, plan.shards[1:]):
        assert a.stop == b.start


def test_plan_clamps_num_shards_to_extent():
    """A 4-way mesh over a 2-head cache plans 2 useful shards."""
    op, args, kw = _inputs("attention", 256)
    plan = plan_for(op, 4, *args, **kw)
    assert plan.spec.kind == "head"
    assert plan.spec.num_shards == 2  # KH = 2 in make_inputs


def test_stencil_plan_halo_clips_at_domain_edges():
    op, args, kw = _inputs("stencil", 48)
    plan = plan_for(op, 3, *args, **kw)
    halo = plan.spec.halo
    assert halo == kw["steps"] * args[1].radius and halo > 0
    first, last = plan.shards[0], plan.shards[-1]
    assert first.lo == 0 and first.hi == halo
    assert last.lo == halo and last.hi == 0
    for mid in plan.shards[1:-1]:
        assert mid.lo == halo and mid.hi == halo


def test_plan_invariants_reject_bad_construction():
    spec = ShardSpec(kind="data", num_shards=2)
    with pytest.raises(ValueError):  # shard count mismatch
        ShardPlan(spec=spec, shards=(Shard(0, 0, 10),), extent=10)
    with pytest.raises(ValueError):  # does not partition the extent
        ShardPlan(spec=spec,
                  shards=(Shard(0, 0, 4), Shard(1, 4, 8)), extent=10)


# --------------------------------------------------------------------------
# sharded execution is exact
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_plain_is_bit_equal_to_unsharded(kernel, engine, n):
    op, args, kw = _inputs(kernel)
    full = op(*args, engine=engine, backend="plain", **kw)
    run = ShardedExecutor(n, engine=engine, backend="plain").run(
        op, *args, **kw)
    assert run.out.shape == full.shape and run.out.dtype == full.dtype
    assert torch.equal(run.out, full)
    assert len(run.shard_seconds) == run.plan.spec.num_shards
    assert run.parallel_s <= run.serial_s + 1e-12


@pytest.mark.parametrize("kernel", KERNELS)
def test_sharded_execution_matches_oracle(kernel):
    op, args, kw = _inputs(kernel)
    want = op.reference(*args, **kw).float()
    run = ShardedExecutor(2, backend="plain").run(op, *args, **kw)
    assert run.out.shape == want.shape
    torch.testing.assert_close(run.out.float(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,kh,g,dh", [(4, 8, 4, 128), (4, 4, 16, 128),
                                       (2, 8, 4, 160)])
def test_head_split_plain_attention_is_bit_equal(engine, dtype, b, kh, g,
                                                 dh):
    """Mistral-NeMo's, Qwen3-MoE's and StableLM's decode heads: a batched
    matmul over fewer heads blocks no differently."""
    op = registry.get("attention")
    rng = np.random.default_rng(3)
    s = 256
    q = cast(rng.standard_normal((b, kh, g, dh)), dtype, "cpu")
    k, v = (cast(rng.standard_normal((b, s, kh, dh)), dtype, "cpu")
            for _ in range(2))
    full = op(q, k, v, s - 32, engine=engine, backend="plain")
    for n in (3, 4):
        run = ShardedExecutor(n, engine=engine, backend="plain").run(
            op, q, k, v, s - 32)
        assert torch.equal(run.out, full)


def test_stencil_halo_correctness():
    """The sharded stencil equals the unsharded run bit for bit."""
    op, args, kw = _inputs("stencil", 48, seed=1)
    unsharded = op(*args, engine="vector", backend="plain", **kw)
    for n in (2, 3):
        run = ShardedExecutor(n, engine="vector", backend="plain").run(
            op, *args, **kw)
        assert torch.equal(run.out, unsharded)


def test_stencil_sharded_without_halo_is_wrong():
    """The halo is load-bearing: dropping it corrupts boundary rows."""
    op, args, kw = _inputs("stencil", 48, seed=1)
    want = op.reference(*args, **kw).float()
    plan = plan_for(op, 2, *args, **kw)
    bad = dataclasses.replace(
        plan,
        spec=dataclasses.replace(plan.spec, halo=0),
        shards=tuple(dataclasses.replace(s, lo=0, hi=0)
                     for s in plan.shards))
    run = ShardedExecutor(2, engine="vector", backend="plain").run(
        op, *args, plan=bad, **kw)
    err = float((run.out.float() - want).abs().max())
    assert err > 1e-3, "halo-less split unexpectedly matched the oracle"


def test_single_shard_degenerates_to_plain_call():
    op, args, kw = _inputs("triad", 4096)
    run = ShardedExecutor(1, backend="plain").run(op, *args, **kw)
    assert torch.equal(run.out, op(*args, backend="plain", **kw))
    assert run.plan.spec.num_shards == 1


def test_shard_call_hands_contiguous_aligned_tensors():
    """Head slices of q / K / V are strided views and a data shard may
    start off a 16-byte boundary: the kernels get tensors of their own."""
    op, args, kw = _inputs("attention", 256)
    plan = plan_for(op, 2, *args, **kw)
    sargs, skw = shard_call(plan, plan.shards[1], args, kw)
    for t in sargs[:3]:
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
    assert torch.equal(sargs[1], args[1][:, :, 1:2])
    # the unsharded call's B * KH rides along for the split-S schedule
    assert skw["split_pairs"] == args[0].shape[0] * args[0].shape[1]
    op, args, kw = _inputs("scale", 1001)
    plan = plan_for(op, 3, *args, **kw)
    for shard in plan.shards:
        sargs, _ = shard_call(plan, shard, args, kw)
        assert sargs[0].data_ptr() % 16 == 0
        assert torch.equal(sargs[0], args[0][shard.start:shard.stop])


# --------------------------------------------------------------------------
# traffic accounting feeds the shard claims
# --------------------------------------------------------------------------

def test_traffic_data_split_is_exact():
    op, args, kw = _inputs("scale", 2**16)
    plan = plan_for(op, 4, *args, **kw)
    t = traffic(op, plan, args, kw)
    assert t["agg_bytes"] == pytest.approx(t["total_bytes"])
    assert t["shard_bytes"] * 4 == pytest.approx(t["total_bytes"])
    assert t["shard_intensity"] == pytest.approx(
        op.traits(*args, **kw).intensity)


def test_traffic_stencil_halo_overhead_is_positive_and_bounded():
    op, args, kw = _inputs("stencil", 48)
    plan = plan_for(op, 2, *args, **kw)
    t = traffic(op, plan, args, kw)
    rows, halo = args[0].shape[0], plan.spec.halo
    assert t["agg_bytes"] / t["total_bytes"] == pytest.approx(
        (rows + 2 * halo) / rows)
    assert t["shard_intensity"] <= op.traits(*args, **kw).intensity + 1e-9


def test_shard_call_slices_match_manual_slicing():
    op, args, kw = _inputs("axpy", 1024)
    plan = plan_for(op, 2, *args, **kw)
    sargs, _ = shard_call(plan, plan.shards[1], args, kw)
    for orig, sliced in zip(args, sargs):
        if isinstance(orig, torch.Tensor):
            assert torch.equal(sliced, orig.reshape(-1)[512:])
    outs = []
    for shard in plan.shards:
        sa, skw = shard_call(plan, shard, args, kw)
        outs.append(op.reference(*sa, **skw))
    torch.testing.assert_close(
        combine_outputs(plan, outs, template=args[0]),
        op.reference(*args, **kw), atol=1e-5, rtol=0)


def test_traffic_wire_bytes_accounting():
    """wire_bytes is the halo rows a real mesh must move: zero for
    data/head/halo-free splits, lo+hi rows x row bytes for the stencil."""
    for name in ("scale", "spmv", "attention"):
        op, args, kw = _inputs(name)
        plan = plan_for(op, 2, *args, **kw)
        assert traffic(op, plan, args, kw)["wire_bytes"] == 0.0
    op, args, kw = _inputs("stencil", 48)
    plan = plan_for(op, 2, *args, **kw)
    u = args[0]
    row_bytes = int(np.prod(u.shape[1:])) * u.element_size()
    expect = sum(s.lo + s.hi for s in plan.shards) * row_bytes
    assert traffic(op, plan, args, kw)["wire_bytes"] == expect > 0


# --------------------------------------------------------------------------
# dispatch + tuning
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_dispatcher_advice_carries_the_reference_spec(kernel):
    op, args, kw = _inputs(kernel)
    jop, jargs, jkw = _j_inputs(kernel)
    for n in (2, 3):
        got = Dispatcher(mesh_shards=n).advise(op, *args, **kw)
        want = JDispatcher(mesh_shards=n).advise(jop, *jargs, **jkw)
        assert got.shard_spec.to_json() == want.shard_spec.to_json()
        assert got.exec_mode == want.exec_mode == "virtual"
        assert got.engine == want.engine


def test_dispatcher_set_mesh_attaches_shard_spec():
    d = Dispatcher(mesh_shards=2)
    op, args, kw = _inputs("scale", 4096)
    advice = d.advise(op, *args, **kw)
    assert advice.shard_spec is not None
    assert advice.shard_spec.num_shards == 2
    assert advice.shard_spec.kind == "data"
    # memoized: the second call is a cache hit carrying the same spec
    assert d.advise(op, *args, **kw) is advice
    # reconfiguring the mesh drops the cache and replans
    d.set_mesh(1)
    assert d.advise(op, *args, **kw).shard_spec is None


def test_dispatcher_mesh_mode_stamped_on_advice():
    d = Dispatcher(mesh_shards=2)
    op, args, kw = _inputs("scale", 4096)
    assert d.mesh_mode == "virtual"
    assert d.advise(op, *args, **kw).exec_mode == "virtual"
    d.set_mesh(2, "mesh")
    advice = d.advise(op, *args, **kw)
    assert advice.exec_mode == "mesh" and advice.shard_spec is not None
    assert Dispatcher(mesh_shards=2, mesh_mode="mesh").mesh_mode == "mesh"
    with pytest.raises(ValueError, match="mesh mode"):
        d.set_mesh(2, "warp")
    assert d.mesh_mode == "mesh" and d.mesh_shards == 2
    # the mode is part of the memo: switching back re-advises
    d.set_mesh(2, "virtual")
    assert d.advise(op, *args, **kw).exec_mode == "virtual"


def test_executor_shards_are_not_replanned_as_sub_splits():
    """Per-shard launches under a mesh-configured dispatcher get no nested
    shard_spec memoized onto their Advice: a shard IS the split."""
    d = Dispatcher(mesh_shards=2)
    ex = ShardedExecutor(2, backend="plain", dispatcher=d)
    op, args, kw = _inputs("scale", 4096)
    run = ex.run(op, *args, **kw)
    torch.testing.assert_close(run.out, op.reference(*args, **kw),
                               atol=1e-5, rtol=0)
    flat = ex._shard_dispatcher()
    assert flat is not d and flat.mesh_shards == 1
    sargs, skw = shard_call(run.plan, run.plan.shards[0], args, kw)
    assert flat.advise(op, *sargs, **skw).shard_spec is None
    assert d.advise(op, *args, **kw).shard_spec.num_shards == 2


def test_spec_for_matches_plan_spec():
    op, args, kw = _inputs("spmv", 128)
    assert spec_for(op, 2, *args, **kw) == plan_for(op, 2, *args, **kw).spec
    assert spec_for(op, 2, *args, **kw).kind in SHARD_KINDS


def test_sharded_lookup_never_inherits_full_width():
    """A sharded launch falls back to the static tiles, never the
    full-width winner's (the reference's tests/test_tuning.py check),
    through the cache, the policy and the dispatcher."""
    from repro_torch.tuning.cache import TunedEntry, TuningCache
    from repro_torch.tuning.cache import shard_shape_of
    hw = Dispatcher().hw.name

    def entry(**kw):
        base = dict(kernel="scale", engine="vector", dtype="float32",
                    hw_model=hw, params={"block_rows": 128, "lanes": 512},
                    best_us=10.0, default_us=20.0, size=4096, source="cuda",
                    budget=4)
        base.update(kw)
        return TunedEntry(**base)
    cache = TuningCache([entry()])
    assert cache.lookup("scale", "vector", "float32", hw) == entry()
    assert cache.lookup("scale", "vector", "float32", hw,
                        shard_shape_of(4)) is None
    per_shard = entry(shard_shape=shard_shape_of(4),
                      params={"block_rows": 64, "lanes": 256}, best_us=4.0)
    cache.add(per_shard)
    assert cache.lookup("scale", "vector", "float32", hw,
                        shard_shape_of(4)) == per_shard
    policy = TuningPolicy(cache)
    assert policy.lookup("scale", "vector", "float32", hw) == entry()
    assert policy.lookup("scale", "vector", "float32", hw,
                         num_shards=4) == per_shard
    assert policy.lookup("scale", "vector", "float32", hw,
                         num_shards=2) is None
    op, args, kw = _inputs("scale", 4096)
    d = Dispatcher(tuning=policy, mesh_shards=4)
    assert d.tile_params(op, "vector", *args, **kw) == \
        {"block_rows": 64, "lanes": 256}
    assert dict(d.advise(op, *args, **kw).tile_config) == \
        {"block_rows": 64, "lanes": 256}
    d.set_mesh(2)
    assert d.tile_params(op, "vector", *args, **kw) is None


# --------------------------------------------------------------------------
# shard claims and the sharded report section (tests/test_report.py)
# --------------------------------------------------------------------------

def _raw(**overrides):
    rec = {
        "kernel": "scale", "engine": "vector", "size": 1024,
        "dtype": "float32", "ref_us_per_call": 100.0, "iqr_us": 5.0,
        "iters": 5, "max_err": 0.0, "intensity": 0.125,
        "memory_bound": True, "engine_auto": "vector",
        "pred_us_v5e": 1.0, "mxu_ceiling": 1.0,
    }
    rec.update(overrides)
    return rec


def _shard_spec(**overrides):
    spec = {"kind": "data", "num_shards": 2, "axis": "data", "halo": 0,
            "total_bytes": 8192.0, "agg_bytes": 8192.0,
            "shard_bytes": 4096.0, "shard_intensity": 0.125,
            "pred_shard_us_v5e": 0.5}
    spec.update(overrides)
    return spec


def _write_schema5(path, records, kernel="scale", mesh=2):
    payload = {"schema": 5, "kernel": kernel,
               "env": {"jax": "0", "device": "cpu", "interpret": True,
                       "hw_model": "TPU-v5e", "mesh_shape": [mesh]},
               "records": records}
    path.write_text(json.dumps(payload))


def _triples(results):
    return [(r.claim, r.passed, r.detail) for r in results]


def test_schema5_shard_spec_round_trip(tmp_path):
    p = tmp_path / "BENCH_scale_mesh2.json"
    _write_schema5(p, [_raw(mesh_shape=[2], shard_spec=_shard_spec())])
    rs = load_file(str(p))
    assert rs.schema == 5 and rs.mesh_devices == 2
    rec = rs.records[0]
    assert rec.mesh_shape == (2,) and rec.num_shards == 2
    assert rec.point[-1] == 2  # shards are part of the join key
    results = check_records([rs])
    assert not violations(results)
    assert tuple(r.claim for r in results)[-2:] == SHARD_CLAIMS
    assert _triples(results) == _triples(j_check_records(
        j_load_dir(str(tmp_path))))


@pytest.mark.parametrize("spec_overrides,expect", [
    ({"shard_intensity": 0.5}, "shard_ceiling"),
    ({"num_shards": 8}, "shard_ceiling"),
    ({"kind": "diagonal"}, "shard_ceiling"),
    ({"agg_bytes": 4096.0}, "shard_traffic"),
    ({"agg_bytes": 9000.0}, "shard_traffic"),
    ({"shard_bytes": 1000.0}, "shard_traffic"),
    ({"kind": "rowblock", "agg_bytes": 819200.0,
      "shard_bytes": 409600.0}, "shard_traffic"),
])
def test_shard_claim_violations_detected(tmp_path, spec_overrides,
                                         expect):
    p = tmp_path / "BENCH_scale_mesh2.json"
    _write_schema5(p, [_raw(mesh_shape=[2],
                            shard_spec=_shard_spec(**spec_overrides))])
    got = check_records([load_file(str(p))])
    assert expect in {v.claim for v in violations(got)}
    assert _triples(got) == _triples(j_check_records(
        j_load_dir(str(tmp_path))))


def test_report_renders_sharded_section(tmp_path):
    runs = tmp_path / "runs"
    runs.mkdir()
    payload = {"schema": 2, "kernel": "scale",
               "env": {"jax": "0", "device": "cpu", "interpret": True,
                       "hw_model": "TPU-v5e"},
               "records": [_raw()]}
    (runs / "BENCH_scale.json").write_text(json.dumps(payload))
    _write_schema5(runs / "BENCH_scale_mesh2.json",
                   [_raw(mesh_shape=[2], shard_spec=_shard_spec())])
    report = render_report(load_dir(str(runs)))
    assert "## Sharded execution" in report
    assert "zero shard-claim violations" in report
    assert "scale-mesh2.md" in report
    # the single-device claim table does not double-count mesh sets
    assert report.count("| scale | 1 |") == 1
    assert "| scale | 2-way | vector | 1024 | float32 | data | 0 | 1x | " \
        "0.5 | 1 | 1x | ✅ |" in report


# --------------------------------------------------------------------------
# the sweep and serving under a mesh, on the CPU
# --------------------------------------------------------------------------

def test_cli_mesh_sweep_writes_records_that_pass(tmp_path):
    from repro_torch.bench import compare, run as bench_run
    out = tmp_path / "m3"
    bench_run.main(["kernels", "--device", "cpu", "--mesh", "3",
                    "--out", str(out)])
    sets = load_dir(str(out))
    assert sorted(rs.kernel for rs in sets) == sorted(KERNELS)
    assert all(rs.mesh_devices == 3 and rs.env["mesh_exec_mode"] ==
               "virtual" for rs in sets)
    results = check_records(sets)
    assert not violations(results)
    assert set(SHARD_CLAIMS) <= {r.claim for r in results}
    for rs in sets:
        raw = json.loads(pathlib.Path(rs.path).read_text())["records"]
        for rec in raw:
            run = rec["shard_run"]
            assert run["equal_unsharded"] is True
            assert len(run["shard_wall_us"]) == \
                rec["shard_spec"]["num_shards"]
            assert run["parallel_us"] <= run["serial_us"]
            assert run["shard_event_us"] is None  # the CPU: not measured
    assert compare.compare(str(out), str(out), mesh=3) == []
    assert compare.compare(str(out), str(out), mesh=1) != []  # empty


def test_records_check_other_widths_untimed():
    from repro_torch.bench import bench_kernels
    for name in ("scale", "stencil", "attention"):
        op = registry.get(name)
        recs = bench_kernels.records_for(op, device="cpu", mesh=2,
                                         check_widths=(3,))
        assert recs and all(r["shard_run"]["equal_unsharded_at"] ==
                            {"3": True} for r in recs)


def test_serving_batcher_reports_shard_count():
    from repro_torch.serving import SessionConfig, run_session
    cfg = SessionConfig(kernel="scale", size=8192, duration_s=0.3,
                        rate_rps=32.0, num_shards=2, seed=3, device="cpu",
                        backend="plain")
    log, summary, record = run_session(cfg)
    assert summary.completed > 0
    assert record["num_shards"] == 2
    assert record["mesh_exec_mode"] == "virtual"
    assert all(b[4] > 0 for b in log.batches)
    cfg1 = dataclasses.replace(cfg, num_shards=1)
    assert run_session(cfg1)[2]["mesh_exec_mode"] is None


def test_sharded_session_record_fields_equal_reference():
    """The same 2-way session in both packages: the same requests, batches
    and record fields apart from the measured times."""
    from repro.serving import SessionConfig as JConfig
    from repro.serving import run_session as j_run_session
    from repro_torch.serving import SessionConfig, run_session
    kw = dict(kernel="scale", size=8192, duration_s=0.3, rate_rps=32.0,
              num_shards=2, seed=3)
    _, _, got = run_session(SessionConfig(device="cpu", backend="plain",
                                          **kw))
    _, _, want = j_run_session(JConfig(**kw))
    for field in ("offered", "completed", "num_shards", "mesh_exec_mode",
                  "engine", "engine_auto", "intensity", "memory_bound",
                  "mxu_ceiling", "max_batch"):
        assert got[field] == want[field], field


@pytest.mark.parametrize("kernel", ["spmv", "stencil", "attention"])
def test_sequential_families_serve_sharded(kernel):
    from repro_torch.serving import SessionConfig, run_session
    op = registry.get(kernel)
    cfg = SessionConfig(kernel=kernel, size=op.test_size, duration_s=0.2,
                        rate_rps=32.0, num_shards=2, seed=1, device="cpu",
                        backend="plain")
    log, summary, record = run_session(cfg)
    assert summary.completed == summary.offered > 0
    assert record["num_shards"] == 2
    assert all(b[4] > 0 for b in log.batches)


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
def test_card_sharded_kernels_are_bit_equal(card, kernel):
    op = registry.get(kernel)
    for dtype in op.dtypes:
        args, kw = op.make_inputs(np.random.default_rng(0),
                                  op.test_size or 1024, dtype, "cuda")
        for engine in ENGINES:
            full = op(*args, engine=engine, **kw)
            for n in (3, 4):
                run = ShardedExecutor(n, engine=engine).run(op, *args, **kw)
                assert torch.equal(run.out, full), (dtype, engine, n)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,kh,g,dh,s", [(4, 8, 4, 128, 4096),
                                         (4, 4, 16, 128, 4096),
                                         (4, 32, 1, 112, 512)])
def test_card_head_shards_are_bit_equal(card, engine, dtype, b, kh, g, dh,
                                        s):
    """K4's head shards run the unsharded call's split-S schedule: each
    shard's heads equal the unsharded call's bit for bit."""
    op = registry.get("attention")
    rng = np.random.default_rng(7)
    q = cast(rng.standard_normal((b, kh, g, dh)), dtype, "cuda")
    k, v = (cast(rng.standard_normal((b, s, kh, dh)), dtype, "cuda")
            for _ in range(2))
    full = op(q, k, v, s - s // 8, engine=engine)
    for n in (2, 3, 4):
        run = ShardedExecutor(n, engine=engine).run(op, q, k, v,
                                                    s - s // 8)
        assert torch.equal(run.out, full), n
