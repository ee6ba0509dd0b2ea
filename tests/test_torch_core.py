"""Parity of the port's analytic core and dispatcher with the JAX reference.

The analytic layer (hw -> balance -> roofline -> intensity -> bounds ->
advisor) is pure arithmetic, so the port must agree exactly on every
platform the reference knows.  For the H100, which the reference lacks,
a reference ``HardwareSpec`` carrying the port's numbers stands in.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro.core import advisor as j_advisor  # noqa: E402
from repro.core import balance as j_balance  # noqa: E402
from repro.core import bounds as j_bounds  # noqa: E402
from repro.core import hw as j_hw  # noqa: E402
from repro.core import intensity as j_int  # noqa: E402
from repro.core import roofline as j_roof  # noqa: E402
from repro.core.dispatch import Dispatcher as JDispatcher  # noqa: E402
from repro.core.dispatch import default_cache_key as j_key  # noqa: E402
from repro.kernels import registry as j_registry  # noqa: E402

from repro_torch.core import advisor as p_advisor  # noqa: E402
from repro_torch.core import balance as p_balance  # noqa: E402
from repro_torch.core import bounds as p_bounds  # noqa: E402
from repro_torch.core import hw as p_hw  # noqa: E402
from repro_torch.core import intensity as p_int  # noqa: E402
from repro_torch.core import roofline as p_roof  # noqa: E402
from repro_torch.core.dispatch import Dispatcher as PDispatcher  # noqa: E402
from repro_torch.core.dispatch import default_cache_key as p_key  # noqa: E402
from repro_torch.core.dispatch import normalize_engine  # noqa: E402
from repro_torch.core.timing import Timing, busy_us, time_fn  # noqa: E402
from repro_torch.kernels import registry as p_registry  # noqa: E402

SHARED = ("a100", "gh200", "v5e")
INTENSITIES = (1 / 16, 1 / 12, 0.25, 1.0, 3.75, 10.0, 20.25, 100.0, 1e4)


def _ref_spec(spec):
    """A reference HardwareSpec carrying one of the port's specs' numbers."""
    return j_hw.HardwareSpec(
        name=spec.name, mem_bw=spec.mem_bw, l2_bytes=spec.l2_bytes,
        link_bw=spec.link_bw, chips=spec.chips,
        engines={k: j_hw.Engine(e.name, e.peak_flops, e.dtype)
                 for k, e in spec.engines.items()})


def _pairs():
    """(reference spec, port spec) for every platform the port knows."""
    out = [(j_hw.get_platform(k), p_hw.get_platform(k)) for k in SHARED]
    for k in ("h100", "h100pcie", "h100nvl"):
        spec = p_hw.get_platform(k)
        out.append((_ref_spec(spec), spec))
    return out


PAIRS = _pairs()
PAIR_IDS = [p.name for _, p in PAIRS]


@pytest.mark.parametrize("name", SHARED)
def test_shared_platforms_identical(name):
    assert dataclasses.asdict(p_hw.get_platform(name)) == \
        dataclasses.asdict(j_hw.get_platform(name))


def test_h100_datasheet_numbers():
    h = p_hw.get_platform("h100")
    assert (h.vector.peak_flops, h.matrix.peak_flops, h.mem_bw) == \
        (34e12, 67e12, 3.35e12)
    assert h.l2_bytes == 50 * 2**20 and h.link_bw == 900e9 / 18
    assert p_advisor.EngineAdvisor().hw is p_hw.H100_SXM
    # alpha = 67/34 puts the Eq. 23 ceiling at 2 - 2/(1 + alpha) = 1.3267
    assert p_bounds.tensor_core_upper_bound(h.alpha) == pytest.approx(
        2 - 68 / 101)


@pytest.mark.parametrize("device_name,want", [
    ("NVIDIA H100 80GB HBM3", "H100-SXM5"),
    ("NVIDIA H100 SXM5 80GB", "H100-SXM5"),
    ("NVIDIA H100 PCIe", "H100-PCIe"),
    ("NVIDIA H100 NVL", "H100-NVL"),
])
def test_spec_for_device_name(device_name, want):
    assert p_hw.spec_for_device_name(device_name).name == want


@pytest.mark.parametrize("device_name", ["NVIDIA A100-SXM4-80GB", "cpu", ""])
def test_spec_for_unknown_device_raises(device_name):
    with pytest.raises(ValueError):
        p_hw.spec_for_device_name(device_name)


@pytest.mark.parametrize("dsize", [8, 4, 2])
def test_paper_table_equal(dsize):
    assert [dataclasses.astuple(t) for t in p_int.paper_table(dsize)] == \
        [dataclasses.astuple(t) for t in j_int.paper_table(dsize)]


def test_intensity_formulas_equal():
    cases = [
        ("scale", (1 << 20, 4)), ("triad", (1 << 20, 2)),
        ("axpy", (12345, 4)), ("gemv", (512, 256, 8)),
        ("spmv_csr", (4096, 4096, 9 * 4096)),
        ("spmv_bell", (128, 256, 16, 8, 128)),
        ("stencil", (27, 3, 4, 512 ** 3)),
        ("stencil_matmul", (5, 1, 128, 3, 4)),
    ]
    for fn, args in cases:
        got = getattr(p_int, fn)(*args)
        want = getattr(j_int, fn)(*args)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), fn
    assert p_int.temporal_depth_to_compute_bound(5, 10.0) == \
        j_int.temporal_depth_to_compute_bound(5, 10.0)


@pytest.mark.parametrize("ref,port", PAIRS, ids=PAIR_IDS)
def test_balance_roofline_bounds_equal(ref, port):
    for eng in ("vector", "matrix"):
        assert p_balance.machine_balance(port, eng) == \
            j_balance.machine_balance(ref, eng)
    assert p_bounds.tensor_core_upper_bound(port.alpha) == \
        j_bounds.tensor_core_upper_bound(ref.alpha)
    for i in INTENSITIES:
        assert p_bounds.best_case_speedup(port, i) == \
            j_bounds.best_case_speedup(ref, i)
        assert p_balance.is_memory_bound(i, port) == \
            j_balance.is_memory_bound(i, ref)
        assert dataclasses.astuple(p_roof.place("k", i, port)) == \
            dataclasses.astuple(j_roof.place("k", i, ref))
    for target in (1.0, 1.2, 4 / 3, 1.9, 2.0):
        assert p_bounds.break_even_alpha(target) == \
            j_bounds.break_even_alpha(target)
    assert p_bounds.speedup_unoverlapped(2.0, 1.0, 3.0, 0.5) == \
        j_bounds.speedup_unoverlapped(2.0, 1.0, 3.0, 0.5)


@pytest.mark.parametrize("overlap", [1.0, 0.0])
@pytest.mark.parametrize("ref,port", PAIRS, ids=PAIR_IDS)
def test_advisor_equal(ref, port, overlap):
    pa = p_advisor.EngineAdvisor(port, overlap_assumption=overlap)
    ja = j_advisor.EngineAdvisor(ref, overlap_assumption=overlap)
    traits = [(p_int.paper_table(d), j_int.paper_table(d)) for d in (8, 4)]
    traits.append(((p_int.stencil(27, 3, 4),), (j_int.stencil(27, 3, 4),)))
    traits.append(((p_int.gemv(4096, 4096, 2),), (j_int.gemv(4096, 4096, 2),)))
    for pts, jts in traits:
        for pt, jt in zip(pts, jts):
            assert dataclasses.asdict(pa.advise(pt)) == \
                dataclasses.asdict(ja.advise(jt))


def test_normalize_engine_and_key():
    for flag, want in [("auto", None), ("mxu", "matrix"), ("vpu", "vector"),
                       ("matrix", "matrix"), ("vector", "vector")]:
        assert normalize_engine(flag) == want
    with pytest.raises(ValueError):
        normalize_engine("gpu")
    # torch dtypes reduce to the reference's dtype names
    t = torch.zeros((3, 4), dtype=torch.bfloat16)
    j = np.zeros((3, 4), np.float32)
    assert p_key(t, 2.5, steps=3) == (
        (("arr", (3, 4), "bfloat16"), 2.5), (("steps", 3),))
    assert j_key(j, 2.5, steps=3) == (
        (("arr", (3, 4), "float32"), 2.5), (("steps", 3),))


def _sequence():
    """A fixed call sequence over (op name, size, dtype)."""
    return [("scale", 1000, "float32"), ("scale", 1000, "float32"),
            ("triad", 1000, "bfloat16"), ("scale", 2000, "float32"),
            ("axpy", 1000, "float32"), ("scale", 1000, "bfloat16"),
            ("spmv", 64, "float32"), ("spmv", 64, "float32"),
            ("stencil", 16, "float32"), ("triad", 1000, "bfloat16"),
            ("stencil", 16, "float32"), ("axpy", 1000, "float32")]


def test_dispatcher_cache_info_equal():
    ref_hw = _ref_spec(p_hw.H100_SXM)
    jd = JDispatcher(advisor=j_advisor.EngineAdvisor(ref_hw))
    pd = PDispatcher(advisor=p_advisor.EngineAdvisor(p_hw.H100_SXM))
    for name, size, dtype in _sequence():
        jop, pop = j_registry.get(name), p_registry.get(name)
        jargs, jkw = jop.make_inputs(np.random.default_rng(0), size, dtype)
        pargs, pkw = pop.make_inputs(np.random.default_rng(0), size, dtype,
                                     device="cpu")
        ja = jd.advise(jop, *jargs, **jkw)
        pa = pd.advise(pop, *pargs, **pkw)
        assert dataclasses.asdict(pa) == dataclasses.asdict(ja), name
        assert pd.cache_info() == jd.cache_info(), name
        assert pd.resolve(pop, *pargs, **pkw) == jd.resolve(jop, *jargs, **jkw)
    t = p_int.scale(100)
    assert pd.advise_traits(t) == pd.advise_traits(t)
    assert pd.cache_info()["hits"] == jd.cache_info()["hits"] + 1
    pd.cache_clear()
    assert pd.cache_info() == {"size": 0, "hits": 0, "misses": 0}
    assert pd.tile_params(p_registry.get("scale"), "vector") is None


def test_time_fn_cpu():
    x = torch.arange(1000, dtype=torch.float32)
    t = time_fn(torch.mul, x, 2.0, warmup=1, iters=7)
    assert isinstance(t, Timing) and t.iters == 7
    assert len(t.samples_us) == 7 and t.median_us > 0 and t.iqr_us >= 0
    assert min(t.samples_us) <= t.median_us <= max(t.samples_us)


def test_time_fn_takes_the_reference_signature():
    """Keywords name spans and never reach ``fn``; ``warmup=0`` runs ``fn``
    exactly ``iters`` times; a closure is timed on the host clock."""
    calls = []

    def fn(*args, **kwargs):
        calls.append((args, kwargs))
        return torch.zeros(3)

    t = time_fn(fn, 1, 2, warmup=0, iters=4, label="x", layer="kernel",
                kernel="scale", size=8, dtype="float32")
    assert t.iters == 4 and len(t.samples_us) == 4
    assert calls == [((1, 2), {})] * 4
    calls.clear()
    time_fn(lambda: fn(), warmup=3, iters=2)
    assert len(calls) == 5


@pytest.mark.parametrize("spans,busy", [
    ([], 0.0),
    ([(0.0, 5.0)], 5.0),
    ([(0.0, 5.0), (7.0, 9.0)], 7.0),        # a gap counts for nothing
    ([(3.0, 10.0), (0.0, 5.0)], 10.0),      # an overlap counts once
    ([(0.0, 10.0), (2.0, 4.0)], 10.0),      # a span inside another
])
def test_busy_us_counts_overlaps_once(spans, busy):
    assert busy_us(spans) == busy
