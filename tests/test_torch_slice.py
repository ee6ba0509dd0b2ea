"""The slice as a whole: registry, seeded inputs, routing and Advice.

The port's registry holds every one of the reference's families;
``make_inputs`` from one seed gives the
reference's inputs bit for bit; every op through the default dispatcher
(``engine=auto|vector|matrix``, ``backend="plain"`` on the CPU) matches
the reference registry op; and the memoized Advice matches field by
field when both advisors model the same hardware.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro.core import advisor as j_advisor  # noqa: E402
from repro.core import hw as j_hw  # noqa: E402
from repro.core.dispatch import Dispatcher as JDispatcher  # noqa: E402
from repro.kernels import registry as j_registry  # noqa: E402

from repro_torch.carry import from_numpy  # noqa: E402
from repro_torch.core import advisor as p_advisor  # noqa: E402
from repro_torch.core import hw as p_hw  # noqa: E402
from repro_torch.core.dispatch import Dispatcher as PDispatcher  # noqa: E402
from repro_torch.kernels import registry as p_registry  # noqa: E402
from repro_torch.kernels.spmv.ref import BlockEll  # noqa: E402

NAMES = ("attention", "axpy", "scale", "spmv", "stencil", "triad")
CASES = [(n, dt) for n in NAMES for dt in p_registry.get(n).dtypes]
CASE_IDS = [f"{n}-{dt}" for n, dt in CASES]
ATOL = {"attention": 1e-5, "spmv": 1e-5, "stencil": 1e-5}


def _flat(args):
    out = []
    for a in args:
        if isinstance(a, BlockEll):
            out += [a.blocks, a.cols]
        elif isinstance(a, torch.Tensor):
            out.append(a)
    return out


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _inputs(name, dtype):
    jop, pop = j_registry.get(name), p_registry.get(name)
    jargs, jkw = jop.make_inputs(np.random.default_rng(0), jop.test_size,
                                 dtype)
    pargs, pkw = pop.make_inputs(np.random.default_rng(0), pop.test_size,
                                 dtype, device="cpu")
    return jop, pop, (jargs, jkw), (pargs, pkw)


def test_registry_names_match_reference_minus_attention():
    """Decode attention arrived with the LM-decode slice: a full match."""
    assert p_registry.names() == NAMES
    assert j_registry.names() == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_op_metadata_matches_reference(name):
    jop, pop = j_registry.get(name), p_registry.get(name)
    for field in ("bench_sizes", "dtypes", "test_size", "shard_kind"):
        assert getattr(pop, field) == getattr(jop, field), field
    assert dict(pop.tile_space) == dict(jop.tile_space)
    assert dict(pop.tile_defaults) == dict(jop.tile_defaults)
    assert pop.tune_proxy is None  # arrives with the tuning slice


@pytest.mark.parametrize("name,dtype", CASES, ids=CASE_IDS)
def test_make_inputs_bit_equal(name, dtype):
    _, _, (jargs, jkw), (pargs, pkw) = _inputs(name, dtype)
    cargs, ckw = from_numpy(jargs, jkw, device="cpu")
    got, want = _flat(pargs), _flat(cargs)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    assert pkw == ckw
    for g, w in zip(pargs, cargs):
        if not isinstance(g, (torch.Tensor, BlockEll)):
            assert g == w


@pytest.mark.parametrize("engine", ["auto", "vector", "matrix"])
@pytest.mark.parametrize("name,dtype", CASES, ids=CASE_IDS)
def test_op_plain_matches_reference_op(name, dtype, engine):
    jop, pop, (jargs, jkw), (pargs, pkw) = _inputs(name, dtype)
    want = np.asarray(jop(*jargs, engine=engine, **jkw), np.float32)
    got = pop(*pargs, engine=engine, backend="plain", **pkw)
    assert tuple(got.shape) == want.shape
    g = got.float().numpy()
    if dtype == "bfloat16":
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(g - want) <= ulp)
    else:
        np.testing.assert_allclose(g, want, rtol=1e-6,
                                   atol=ATOL.get(name, 0.0))


def _ref_spec(spec):
    return j_hw.HardwareSpec(
        name=spec.name, mem_bw=spec.mem_bw, l2_bytes=spec.l2_bytes,
        link_bw=spec.link_bw, chips=spec.chips,
        engines={k: j_hw.Engine(e.name, e.peak_flops, e.dtype)
                 for k, e in spec.engines.items()})


@pytest.mark.parametrize("platform", ["h100", "v5e", "a100"])
@pytest.mark.parametrize("name,dtype", CASES, ids=CASE_IDS)
def test_advice_matches_field_by_field(name, dtype, platform):
    jop, pop, (jargs, jkw), (pargs, pkw) = _inputs(name, dtype)
    spec = p_hw.get_platform(platform)
    jd = JDispatcher(advisor=j_advisor.EngineAdvisor(_ref_spec(spec)))
    pd = PDispatcher(advisor=p_advisor.EngineAdvisor(spec))
    ja, pa = jd.advise(jop, *jargs, **jkw), pd.advise(pop, *pargs, **pkw)
    assert dataclasses.asdict(pa) == dataclasses.asdict(ja)
    assert pa.tile_config is None and pa.shard_spec is None
    assert pa.exec_mode == "virtual"


@pytest.mark.parametrize("name", NAMES)
def test_auto_routes_to_vector_at_test_size(name):
    """Every family is memory-bound at its test size on the H100, so the
    paper's §6 rule sends 'auto' to the CUDA-core kernel."""
    pop = p_registry.get(name)
    args, kw = pop.make_inputs(np.random.default_rng(0), pop.test_size,
                               device="cpu")
    advice = pop.advice(*args, **kw)
    assert advice.memory_bound and advice.engine == "vector"
    auto = pop(*args, engine="auto", backend="plain", **kw)
    vec = pop(*args, engine="vector", backend="plain", **kw)
    assert torch.equal(auto, vec)
