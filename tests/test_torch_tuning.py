"""The port's tuning layer against the reference's ``repro.tuning``.

* ``candidates`` / ``default_params`` equal the reference's for every
  registered family; ``tune_op`` under one fixed-sequence timer picks the
  reference's winner with the same ``best_us`` / ``default_us``.
* A ``tuned.json`` written by either package loads in the other with the
  same entries; the committed (TPU-v5e) cache loads in the port and never
  answers an H100 lookup.  Plain-version timings are refused at persist.
* ``select_index``, ``replay`` and ``OnlineTuner`` give the reference's
  arm sequences on the same observations (hypothesis-generated).
* The tuned dispatch: a cache hit applies its params below an explicit
  ``tile_config`` and explicit kwargs, a stale key warns and never
  raises, and the environment variable is the port's own.
"""
import json
import pathlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels import registry as j_registry  # noqa: E402
from repro.tuning import cache as j_cache  # noqa: E402
from repro.tuning import online as j_online  # noqa: E402
from repro.tuning import tuner as j_tuner  # noqa: E402

from repro_torch.core.dispatch import (TUNED_CACHE_ENV,  # noqa: E402
                                       Dispatcher, TuningPolicy)
from repro_torch.core.intensity import KernelTraits  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.registry import EngineOp  # noqa: E402
from repro_torch.tuning import (InterpretTimingError,  # noqa: E402
                                OnlineTuner, TunedEntry, TuningCache,
                                candidates, default_params, replay,
                                select_index, tune_op)
from repro_torch.tuning.cache import TuningCacheWarning  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
NAMES = ("attention", "axpy", "scale", "spmv", "stencil", "triad")
TUNABLE = ("attention", "axpy", "scale", "stencil", "triad")
H100 = "H100-SXM5"


# -- the search ----------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("budget", [None, 1, 3, 8])
def test_candidates_and_defaults_match_reference(name, budget):
    op, jop = registry.get(name), j_registry.get(name)
    assert default_params(op) == j_tuner.default_params(jop)
    assert candidates(op, budget) == j_tuner.candidates(jop, budget)


class _Timing:
    def __init__(self, us):
        self.median_us = us


def _sequence_timer(values, fail_at=()):
    """A timer that never runs its function: the i-th call returns
    values[i] (raising at the indices in *fail_at*)."""
    calls = []

    def timer(fn):
        del fn
        i = len(calls)
        calls.append(i)
        if i in fail_at:
            raise RuntimeError(f"candidate {i} refused")
        return _Timing(values[i % len(values)])
    return timer


@pytest.mark.parametrize("fail_at", [(), (2,)])
@pytest.mark.parametrize("engine", ["vector", "matrix"])
@pytest.mark.parametrize("name", TUNABLE)
def test_tune_op_picks_the_reference_winner(name, engine, fail_at):
    values = [5.0, 3.25, 7.5, 3.0, 4.0, 9.0]
    dtype = registry.get(name).dtypes[-1]
    got = tune_op(registry.get(name), engine=engine, dtype=dtype,
                  backend="plain", hw_model=H100,
                  timer=_sequence_timer(values, fail_at))
    want = j_tuner.tune_op(j_registry.get(name), engine=engine, dtype=dtype,
                           source="pallas", interpret=True, hw_model=H100,
                           timer=_sequence_timer(values, fail_at))
    assert dict(got.params) == dict(want.params)
    assert (got.best_us, got.default_us, got.size, got.budget) == \
        (want.best_us, want.default_us, want.size, want.budget)
    assert got.source == "plain" and want.source == "pallas-interpret"


def test_tune_op_without_tile_space_returns_none():
    assert tune_op(registry.get("spmv"), engine="vector",
                   backend="plain") is None


def test_proxy_source_fails_as_the_reference_does():
    """Every port family's tune_proxy is None: each candidate is skipped
    with the reference's message and the search fails."""
    with pytest.raises(RuntimeError, match="declares no tune_proxy"):
        tune_op(registry.get("scale"), engine="vector", source="proxy",
                backend="plain", size=4096)


def test_plain_timings_are_refused_at_persist():
    entry = tune_op(registry.get("scale"), engine="vector", backend="plain",
                    size=4096, timer=_sequence_timer([1.0]))
    with pytest.raises(InterpretTimingError, match="plain"):
        TuningCache().add(entry)


def test_tune_op_inputs_need_a_size():
    op = registry.get("scale")
    args = op.make_inputs(np.random.default_rng(0), 64, "float32", "cpu")
    with pytest.raises(ValueError, match="size="):
        tune_op(op, engine="vector", backend="plain", inputs=args)
    entry = tune_op(op, engine="vector", backend="plain", inputs=args,
                    size=64, timer=_sequence_timer([2.0, 1.0]))
    assert entry.size == 64 and entry.best_us == 1.0


# -- the cache file, both ways -------------------------------------------------

def _port_cache():
    return TuningCache([
        TunedEntry("stencil", "vector", "float32", H100,
                   {"block_rows": 64}, 297.125, 301.5, 8192),
        TunedEntry("attention", "matrix", "bfloat16", H100,
                   {"block_s": 256}, 158.25, 160.0, 32768, budget=3),
        TunedEntry("scale", "vector", "float32", H100,
                   {"block_rows": 128, "lanes": 512}, 181.5, 181.75,
                   2**26, shard_shape="2-way"),
    ], fingerprint={"torch": "x"})


def _json_entries(cache):
    return [e.to_json() for e in cache]


def test_port_cache_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "tuned.json")
    _port_cache().save(path)
    got = j_cache.TuningCache.load(path)
    assert _json_entries(got) == _json_entries(_port_cache())
    assert json.loads(open(path).read())["schema"] == 2


def test_reference_cache_loads_in_the_port(tmp_path):
    path = str(tmp_path / "tuned.json")
    ref = j_cache.TuningCache([
        j_cache.TunedEntry("triad", "vector", "bfloat16", "TPU-v5e",
                           {"block_rows": 512, "lanes": 512}, 10.0, 12.0,
                           4096, source="xla-proxy", budget=8),
        j_cache.TunedEntry("stencil", "matrix", "float32", H100,
                           {"block_rows": 32}, 5.0, 6.0, 256,
                           source="online", shard_shape="4-way"),
    ], fingerprint={"jax": "0"})
    ref.save(path)
    assert _json_entries(TuningCache.load(path)) == _json_entries(ref)


def test_committed_cache_loads_and_never_answers_the_card():
    path = str(REPO / "tuned.json")
    cache = TuningCache.load(path)
    want = j_cache.TuningCache.load(path)
    assert _json_entries(cache) == _json_entries(want) and len(cache) > 0
    for e in cache:
        assert e.hw_model == "TPU-v5e"
        assert cache.lookup(e.kernel, e.engine, e.dtype, e.hw_model) is e
        assert cache.lookup(e.kernel, e.engine, e.dtype, H100) is None


def test_load_or_warn_degrades_to_empty(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.warns(TuningCacheWarning, match="static tile defaults"):
        assert len(TuningCache.load_or_warn(str(bad))) == 0
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps({"schema": 1, "entries": [
        {"kernel": "scale", "engine": "vector", "dtype": "float32",
         "hw_model": H100, "params": {"block_rows": 128, "lanes": 512},
         "best_us": 1.0, "default_us": 2.0, "size": 8}]}))
    with pytest.warns(TuningCacheWarning, match="schema 1"):
        cache = TuningCache.load_or_warn(str(legacy))
    assert cache.lookup("scale", "vector", "float32", H100, "full")


def test_merge_keeps_the_faster_entry():
    slow = TunedEntry("stencil", "vector", "float32", H100,
                      {"block_rows": 32}, 9.0, 9.0, 1)
    fast = TunedEntry("stencil", "vector", "float32", H100,
                      {"block_rows": 64}, 3.0, 9.0, 1)
    a = TuningCache([fast]).merge(TuningCache([slow]))
    b = TuningCache([slow]).merge(TuningCache([fast]))
    assert dict(a.lookup("stencil", "vector", "float32", H100).params) == \
        dict(b.lookup("stencil", "vector", "float32", H100).params) == \
        {"block_rows": 64}


# -- the online bandit ---------------------------------------------------------

_stats = st.integers(min_value=1, max_value=6).flatmap(
    lambda k: st.tuples(
        st.lists(st.integers(0, 5), min_size=k, max_size=k),
        st.lists(st.floats(0.0, 1e4, allow_nan=False), min_size=k,
                 max_size=k),
        st.integers(0, 40), st.integers(1, 12), st.booleans()))


@settings(max_examples=200, deadline=None)
@given(_stats)
def test_select_index_matches_reference(case):
    pulls, means, total, budget, explore = case
    assert select_index(pulls, means, total, budget, explore) == \
        j_online.select_index(pulls, means, total, budget, explore)


_events = st.lists(st.tuples(st.booleans(),
                             st.floats(0.0, 5e3, allow_nan=False)),
                   max_size=30)


@settings(max_examples=100, deadline=None)
@given(n_arms=st.integers(1, 6), budget=st.integers(1, 10), events=_events,
       bonus=st.sampled_from([0.0, 0.5, 1.0, 3.0]))
def test_replay_matches_reference(n_arms, budget, events, bonus):
    # the arm actually pulled at each step is the policy's own choice, as
    # a faithful record logs it
    log, pulls, sums, total = [], [0] * n_arms, [0.0] * n_arms, 0
    for explore, obs in events:
        means = [sums[i] / pulls[i] if pulls[i] else 0.0
                 for i in range(n_arms)]
        arm = select_index(pulls, means, total, budget, explore, bonus)
        log.append({"arm": arm, "explore": explore, "observed_us": obs})
        pulls[arm] += 1
        sums[arm] += round(obs, 3)
        total += 1
    got = replay(n_arms, budget, log, bonus=bonus)
    assert got == j_online.replay(n_arms, budget, log, bonus=bonus)
    assert got == [e["arm"] for e in log]


@settings(max_examples=60, deadline=None)
@given(name=st.sampled_from(TUNABLE), budget=st.integers(1, 10),
       events=_events, warm=st.booleans())
def test_online_tuner_matches_reference(name, budget, events, warm):
    op, jop = registry.get(name), j_registry.get(name)
    dtype, engine = op.dtypes[0], "vector"
    params = candidates(op)[-1]
    cache = jcache = None
    if warm:
        cache = TuningCache([TunedEntry(name, engine, dtype, H100, params,
                                        1.5, 2.0, 8)])
        jcache = j_cache.TuningCache([j_cache.TunedEntry(
            name, engine, dtype, H100, params, 1.5, 2.0, 8)])
    tuner = OnlineTuner(budget, cache=cache, hw_model=H100)
    jtuner = j_online.OnlineTuner(budget, cache=jcache, hw_model=H100)
    for explore, obs in events:
        choice = tuner.select(op, engine, dtype, explore=explore, size=8)
        jchoice = jtuner.select(jop, engine, dtype, explore=explore, size=8)
        assert (choice.arm, dict(choice.params)) == \
            (jchoice.arm, dict(jchoice.params))
        assert tuner.observe(choice, obs) == jtuner.observe(jchoice, obs)
    assert tuner.payload() == jtuner.payload()
    assert [e.to_json() for e in tuner.to_entries()] == \
        [e.to_json() for e in jtuner.to_entries()]


# -- the tuned dispatch --------------------------------------------------------

def _probe_op(calls):
    def engine(x, *, backend="cuda", **kw):
        calls.append(kw)
        return x
    return EngineOp(
        name="probe", traits=lambda x, **kw: KernelTraits("probe", 1.0, 8.0),
        engines={"vector": engine, "matrix": engine},
        reference=lambda x, **kw: x, make_inputs=None,
        tile_space={"block_rows": (32, 64)}, tile_defaults={"block_rows": 64})


def _dispatcher(params):
    cache = TuningCache([TunedEntry("probe", "vector", "float32", H100,
                                    params, 1.0, 2.0, 8)])
    return Dispatcher(tuning=TuningPolicy(cache)), torch.zeros(4)


def test_cache_hit_applies_its_params_below_explicit_choices():
    calls = []
    op = _probe_op(calls)
    d, x = _dispatcher({"block_rows": 32})
    d.run(op, x, engine="vector", backend="plain")
    d.run(op, x, engine="vector", backend="plain", block_rows=64)
    d.run(op, x, engine="vector", backend="plain", block_rows=None)
    d.run(op, x, engine="vector", backend="plain",
          tile_config={"block_rows": 64})
    d.run(op, x, engine="matrix", backend="plain")
    assert calls == [{"block_rows": 32}, {"block_rows": 64},
                     {"block_rows": 32}, {"block_rows": 64}, {}]
    assert d.advise(op, x).tile_config == (("block_rows", 32),)
    assert d.tile_params(op, "matrix", x) is None


def test_stale_cache_key_warns_and_never_raises():
    calls = []
    op = _probe_op(calls)
    d, x = _dispatcher({"block_rows": 32, "lanes": 512})
    with pytest.warns(TuningCacheWarning, match=r"unknown tile parameter"):
        d.run(op, x, engine="vector", backend="plain")
    assert calls == [{"block_rows": 32}]
    with pytest.raises(ValueError, match="does not accept"):
        d.run(op, x, engine="vector", backend="plain",
              tile_config={"lanes": 512})


def test_set_tuning_cache_drops_memoized_advice():
    op = _probe_op([])
    d, x = _dispatcher({"block_rows": 32})
    assert d.advise(op, x).tile_config == (("block_rows", 32),)
    d.set_tuning_cache(None)
    assert d.advise(op, x).tile_config is None


def test_default_policy_reads_the_ports_own_variable(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    TuningCache([TunedEntry("probe", "vector", "float32", H100,
                            {"block_rows": 32}, 1.0, 2.0, 8)]).save(path)
    assert TUNED_CACHE_ENV == "REPRO_TORCH_TUNED_JSON"
    monkeypatch.delenv(TUNED_CACHE_ENV, raising=False)
    monkeypatch.setenv("REPRO_TUNED_JSON", path)
    assert TuningPolicy().cache is None
    monkeypatch.setenv(TUNED_CACHE_ENV, path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", TuningCacheWarning)
        hit = TuningPolicy().lookup("probe", "vector", "float32", H100)
    assert dict(hit.params) == {"block_rows": 32}
