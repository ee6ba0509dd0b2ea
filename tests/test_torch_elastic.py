"""The port's elastic serving session (``repro_torch.serving.elastic``)
against the reference's ``repro.serving.elastic``, on the CPU.

* The reference's four session drills (``tests/test_fault_tolerance.py``):
  resize under load, a shard failure re-dispatched mid-batch, scheduler
  state surviving a checkpoint / restore, and a checkpoint of another
  seed refused.
* The reference's chaos compare gate and deterministic chaos replay
  (``tests/test_serving.py``).
* Parity: the chaos spec parsing (bad tokens included), the seeded specs,
  ``mesh_transition_plan``, and for the same seeded session the event log,
  the request accounting and the checksum equal the reference's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.runtime.elastic import (  # noqa: E402
    mesh_transition_plan as j_transition)
from repro.serving import BatchPolicy as JPolicy  # noqa: E402
from repro.serving import ChaosInjector as JChaos  # noqa: E402
from repro.serving import ElasticSession as JSession  # noqa: E402
from repro.serving import SessionConfig as JConfig  # noqa: E402

from repro_torch.bench.common import write_serving_json  # noqa: E402
from repro_torch.report import (ELASTIC_CLAIMS, SERVING_CLAIMS,  # noqa: E402
                                TRACE_CLAIMS, check_serving_record,
                                hw_for, load_file)
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime.elastic import mesh_transition_plan  # noqa: E402
from repro_torch.serving import (SLO, BatchPolicy, ChaosInjector,  # noqa: E402
                                 ElasticSession, SessionConfig,
                                 checkpoint_session, session)
from repro_torch.serving.elastic import _parse_chaos_spec  # noqa: E402

PLAIN = dict(device="cpu", backend="plain")


def _elastic_cfg(**overrides):
    """A small, fast serving config for the elastic drills."""
    kw = dict(kernel="scale", workload="bursty", engine="vector",
              rate_rps=64.0, duration_s=0.5, size=4096, dtype="float32",
              seed=0, policy=BatchPolicy(max_batch=4, max_wait_s=0.01),
              slo=SLO(latency_ms=50.0), num_shards=1, **PLAIN)
    kw.update(overrides)
    return SessionConfig(**kw)


def _shape(rec):
    """The replayable invariants: event structure, checksums, request
    accounting (latencies are measured walls and vary)."""
    return {
        "log": [tuple(e.get(k) for k in
                      ("kind", "shard", "width", "from", "to", "reason",
                       "skipped", "redispatch_exact", "reshard_exact"))
                for e in rec["events"]["log"]],
        "checksum": rec["events"]["checksum"],
        "fault_free": rec["events"]["fault_free"]["checksum"],
        "availability": rec["events"]["availability"],
        "offered": rec["offered"], "completed": rec["completed"],
    }


# --------------------------------------------------------------------------
# the reference's session drills
# --------------------------------------------------------------------------

def test_serving_session_resizes_mesh_under_load():
    """Queue-depth pressure grows the mesh; idle traffic shrinks it -- and
    every re-shard is bit-exact against the fault-free replay."""
    cfg = _elastic_cfg(rate_rps=256.0)
    sess = ElasticSession(cfg, min_shards=1, max_shards=4, grow_depth=4,
                          idle_shrink_s=0.05, resize_cooldown_s=0.02)
    _, summary, record = sess.run()
    events = record["events"]
    resizes = [e for e in events["log"] if e.get("kind") == "resize"
               and not e.get("skipped")]
    assert any(e["reason"] == "queue-pressure" for e in resizes), resizes
    assert all(e["reshard_exact"] for e in resizes)
    assert all(e["to"] != e["from"] for e in resizes)
    assert events["checksum"] == events["fault_free"]["checksum"]
    assert summary.completed == summary.offered


def test_shard_failure_redispatch_mid_batch():
    """An injected shard death mid-batch is recovered by re-dispatching
    the dead shard's ShardPlan ranges: same bits, no dropped requests."""
    assert hasattr(session, "redispatch_failed_shard")
    cfg = _elastic_cfg(num_shards=2)
    sess = ElasticSession(cfg, injector=ChaosInjector("fail@0.05:1"),
                          max_shards=2)
    _, summary, record = sess.run()
    events = record["events"]
    fails = [e for e in events["log"] if e.get("kind") == "fail"
             and not e.get("skipped")]
    assert len(fails) == 1
    assert fails[0]["redispatch_exact"] is True
    assert fails[0]["recovery_ms"] >= 0.0
    assert events["failures"] == 1
    assert events["availability"] == 1.0
    assert events["checksum"] == events["fault_free"]["checksum"]
    assert summary.completed == summary.offered


def test_scheduler_state_survives_restart(tmp_path):
    """Serve, checkpoint mid-session, restore into a fresh session, and
    finish: the resumed session completes exactly the remaining requests
    and lands on the uninterrupted run's checksum."""
    assert hasattr(session, "checkpoint_session")
    cfg = _elastic_cfg()
    straight = ElasticSession(cfg)
    log1 = straight.serve(chaos=False)
    rids1 = {r.request.rid for r in log1.results if r.ok}

    interrupted = ElasticSession(cfg)
    interrupted.serve(chaos=False, stop_after_batches=2)
    step = checkpoint_session(interrupted, tmp_path)
    assert ckpt.latest_step(tmp_path) == step
    extra = ckpt.checkpoint_meta(tmp_path, step)["extra"]
    assert extra["tuning"] is not None  # tuner cache rode along

    resumed = ElasticSession.restore(cfg, tmp_path)
    done_before = set(resumed._resume["completed"])
    log3 = resumed.serve(chaos=False)
    rids3 = {r.request.rid for r in log3.results if r.ok}
    assert rids3.isdisjoint(done_before)
    assert rids1 == rids3 | done_before
    assert straight.checksum() == resumed.checksum()


def test_session_restore_rejects_mismatched_seed(tmp_path):
    sess = ElasticSession(_elastic_cfg())
    sess.serve(chaos=False, stop_after_batches=1)
    checkpoint_session(sess, tmp_path)
    with pytest.raises(ValueError, match="cache leaf mismatch"):
        ElasticSession.restore(_elastic_cfg(seed=1), tmp_path)


def test_bfloat16_session_checkpoints_and_restores(tmp_path):
    """A bfloat16 class's canonical inputs ride the checkpoint as the
    reference stores bfloat16, and restore bit for bit."""
    cfg = _elastic_cfg(dtype="bfloat16", kernel="triad")
    straight = ElasticSession(cfg)
    straight.serve(chaos=False)
    interrupted = ElasticSession(cfg)
    interrupted.serve(chaos=False, stop_after_batches=2)
    checkpoint_session(interrupted, tmp_path)
    resumed = ElasticSession.restore(cfg, tmp_path)
    resumed.serve(chaos=False)
    assert straight.checksum() == resumed.checksum()


# --------------------------------------------------------------------------
# the reference's chaos gate and replay (tests/test_serving.py)
# --------------------------------------------------------------------------

def _serving_raw(**overrides):
    rec = {
        "kernel": "scale", "engine": "vector", "engine_auto": "vector",
        "workload": "poisson", "rate_rps": 50.0, "duration_s": 2.0,
        "size": 4096, "dtype": "float32", "seed": 0, "offered": 100,
        "completed": 100, "batches": 20, "mean_batch": 5.0,
        "throughput_rps": 50.0, "p50_ms": 10.0, "p95_ms": 20.0,
        "p99_ms": 25.0, "queue_p50_ms": 5.0, "queue_p99_ms": 15.0,
        "compute_p50_ms": 5.0, "compute_p99_ms": 10.0, "slo_ms": 50.0,
        "slo_attainment": 1.0, "goodput_rps": 50.0, "intensity": 0.125,
        "memory_bound": True, "mxu_ceiling": 1.0, "max_batch": 8,
        "max_wait_ms": 20.0, "num_shards": 2, "mesh_exec_mode": "virtual",
    }
    rec.update(overrides)
    return rec


def _events_raw(**overrides):
    ev = {
        "spec": "fail@0.1:1", "availability": 1.0,
        "availability_target": 0.99, "p99_bound": 10.0,
        "p99_slack_ms": 250.0, "checksum": 123.5,
        "failures": 1, "resizes": 0, "recovery_ms_total": 2.0,
        "fault_free": {"completed": 100, "offered": 100,
                       "p99_ms": 25.0, "checksum": 123.5},
        "log": [{"kind": "fail", "at_s": 0.1, "shard": 1, "width": 2,
                 "batch_id": 3, "recovery_ms": 2.0,
                 "redispatch_exact": True}],
    }
    ev.update(overrides)
    return ev


def _write_serving(path, records):
    payload = {"schema": 4, "kind": "serving", "kernel": "scale",
               "env": {"torch": "0", "device": "cpu",
                       "hw_model": "H100-SXM5"},
               "records": records}
    path.write_text(json.dumps(payload))


def test_chaos_compare_gate(tmp_path):
    """Chaos sessions gate availability, and sessions under different
    injected adversaries refuse to compare at all -- with the reference's
    messages."""
    from benchmarks.compare import compare as j_compare
    from repro_torch.bench.compare import compare

    base, cand = tmp_path / "base", tmp_path / "cand"
    base.mkdir(), cand.mkdir()
    _write_serving(base / "BENCH_serve_scale.json",
                   [_serving_raw(events=_events_raw())])
    _write_serving(cand / "BENCH_serve_scale.json",
                   [_serving_raw(events=_events_raw())])
    assert compare(str(base), str(cand), kind="serving") == []
    _write_serving(cand / "BENCH_serve_scale.json", [_serving_raw(
        completed=50, throughput_rps=25.0, goodput_rps=25.0,
        events=_events_raw(
            availability=0.5,
            fault_free={"completed": 50, "offered": 100,
                        "p99_ms": 25.0, "checksum": 123.5}))])
    msgs = compare(str(base), str(cand), kind="serving")
    assert "availability" in "\n".join(msgs)
    # the H100 env is the port's; the gate's own messages match the
    # reference's on the TPU env
    for d in (base, cand):
        p = d / "BENCH_serve_scale.json"
        raw = json.loads(p.read_text())
        raw["env"] = {"jax": "0", "device": "cpu", "interpret": True,
                      "hw_model": "TPU-v5e"}
        p.write_text(json.dumps(raw))
    assert compare(str(base), str(cand), kind="serving") == \
        j_compare(str(base), str(cand), kind="serving")
    _write_serving(cand / "BENCH_serve_scale.json",
                   [_serving_raw(events=_events_raw(spec="fail@0.3:0"))])
    msgs = "\n".join(compare(str(base), str(cand), threshold=100.0,
                             kind="serving"))
    assert "config mismatch" in msgs and "chaos_spec" in msgs


def test_chaos_replay_is_deterministic(tmp_path):
    """Two elastic sessions under the identical seeded adversary replay
    the same events, checksums and record, which passes every serving
    claim plus elastic_integrity, and equal the reference's session."""
    def _session():
        cfg = SessionConfig(
            kernel="scale", workload="bursty", rate_rps=128,
            duration_s=0.5, size=4096, seed=0, num_shards=2,
            policy=BatchPolicy(max_batch=4, max_wait_s=0.01), **PLAIN)
        return ElasticSession(
            cfg, injector=ChaosInjector("fail@0.05:1,resize@0.1:4"),
            max_shards=4)

    _, _, rec1 = _session().run()
    _, _, rec2 = _session().run()
    assert _shape(rec1) == _shape(rec2)
    assert rec1["events"]["checksum"] == \
        rec1["events"]["fault_free"]["checksum"]
    applied = [e for e in rec1["events"]["log"] if not e.get("skipped")]
    assert any(e["kind"] == "fail" for e in applied)
    jcfg = JConfig(kernel="scale", workload="bursty", rate_rps=128,
                   duration_s=0.5, size=4096, seed=0, num_shards=2,
                   policy=JPolicy(max_batch=4, max_wait_s=0.01))
    _, _, jrec = JSession(jcfg, injector=JChaos("fail@0.05:1,resize@0.1:4"),
                          max_shards=4).run()
    assert _shape(rec1) == _shape(jrec)
    path = write_serving_json("scale", [rec1], str(tmp_path),
                              env={"hw_model": "H100-SXM5"}, mesh=2)
    assert path.endswith("BENCH_serve_scale_mesh2.json")
    rs = load_file(path)
    results = check_serving_record(rs.records[0], hw_for(rs))
    assert (tuple(r.claim for r in results)
            == SERVING_CLAIMS + ELASTIC_CLAIMS + TRACE_CLAIMS)
    assert all(r.passed for r in results)


# --------------------------------------------------------------------------
# parity of the pure parts, and what the session refuses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "fail@0.6:1,resize@1.1:4", "resize@0.2:2, fail@0.1", "",
    "fail@0.3:2,resize@0.3:1,fail@0.05:0"])
def test_chaos_spec_parses_as_the_reference(spec):
    from repro.serving.elastic import _parse_chaos_spec as j_parse
    got = [(e.kind, e.at_s, e.shard, e.width)
           for e in _parse_chaos_spec(spec)]
    want = [(e.kind, e.at_s, e.shard, e.width) for e in j_parse(spec)]
    assert got == want
    assert len(ChaosInjector(spec)) == len(JChaos(spec))


@pytest.mark.parametrize("spec", ["boom@0.1", "fail", "fail@-1",
                                  "resize@0.1", "resize@0.1:0"])
def test_bad_chaos_specs_raise_as_the_reference(spec):
    with pytest.raises(ValueError):
        JChaos(spec)
    with pytest.raises(ValueError):
        ChaosInjector(spec)


@pytest.mark.parametrize("seed", [0, 1, 7, 42])
@pytest.mark.parametrize("max_width", [2, 4])
def test_seeded_chaos_is_the_reference_spec(seed, max_width):
    assert ChaosInjector.seeded(seed, 0.5, max_width=max_width).spec == \
        JChaos.seeded(seed, 0.5, max_width=max_width).spec


@pytest.mark.parametrize("old,new", [({"data": 2}, {"data": 4}),
                                     ({"data": 4}, {"data": 1}),
                                     ({"data": 2, "model": 2},
                                      {"data": 2, "pod": 2})])
def test_mesh_transition_plan_is_the_reference(old, new):
    assert mesh_transition_plan(old, new) == j_transition(old, new)


@pytest.mark.parametrize("kernel,size,rate", [("stencil", 48, 200.0),
                                              ("attention", 256, 200.0)])
def test_per_request_families_survive_chaos(kernel, size, rate):
    """The per-request families under the seeded adversary: re-dispatch
    and re-shard bit-exact, every request served.  Against the reference
    the offered load is the same and the checksum agrees to 1e-7
    relative: the stencil and attention plain versions round differently
    from XLA's fused reference math (ROADMAP Queue 3, rounding facts),
    while the elementwise family's checksum is equal (above)."""
    kw = dict(kernel=kernel, workload="poisson", rate_rps=rate,
              duration_s=0.2, size=size, seed=0, num_shards=1)
    inj = ChaosInjector.seeded(0, 0.2, max_width=4)
    _, summary, rec = ElasticSession(
        SessionConfig(**kw, **PLAIN), injector=inj).run()
    ev = rec["events"]
    assert ev["checksum"] == ev["fault_free"]["checksum"]
    assert ev["availability"] >= 0.99
    for e in ev["log"]:
        if e.get("skipped"):
            continue
        assert e.get("redispatch_exact", True) and \
            e.get("reshard_exact", True)
    _, _, jrec = JSession(JConfig(**kw),
                          injector=JChaos(inj.spec)).run()
    got, want = _shape(rec)["checksum"], _shape(jrec)["checksum"]
    assert abs(got - want) <= 1e-7 * abs(want)
    assert rec["offered"] == jrec["offered"]


def test_session_refusals():
    with pytest.raises(ValueError, match="open-loop"):
        ElasticSession(_elastic_cfg(workload="closed"))
    with pytest.raises(ValueError, match="virtual-mesh only"):
        ElasticSession(_elastic_cfg(real_mesh=True))
    with pytest.raises(RuntimeError, match="nothing to checkpoint"):
        checkpoint_session(ElasticSession(_elastic_cfg()), "unused")
    assert np.isclose(ElasticSession(_elastic_cfg()).checksum(), 0.0)
