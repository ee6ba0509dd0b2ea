"""Per-kernel parity: the port's plain versions against the JAX entry points.

The same seeded numpy inputs go through the reference (Pallas in
interpret mode, as ``tests/test_kernels.py`` runs it) and through the
port's wrappers with ``backend="plain"`` on CPU tensors -- the plain
PyTorch version of each hand-written CUDA kernel, with the kernel's
rounding points.  Tolerances: float32 elementwise rtol 1e-6; bfloat16
within one bfloat16 ulp; SpMV rtol = atol = 1e-5 (summation order);
stencil atol 1e-5 (summation order over <= 3 fused steps).

Tests marked ``gpu`` hold each CUDA kernel against its plain version on
the card; they skip where there is none.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro.kernels.axpy.ops import axpy as j_axpy  # noqa: E402
from repro.kernels.scale.ops import scale as j_scale  # noqa: E402
from repro.kernels.spmv.ops import dense_to_bell as j_dense_to_bell  # noqa: E402
from repro.kernels.spmv.ops import spmv as j_spmv  # noqa: E402
from repro.kernels.spmv.ref import bell_matvec_ref as j_bell_matvec_ref  # noqa: E402
from repro.kernels.stencil.defs import TABLE3_DEPTH  # noqa: E402
from repro.kernels.stencil.defs import suite as j_suite  # noqa: E402
from repro.kernels.stencil.ops import stencil as j_stencil  # noqa: E402
from repro.kernels.triad.ops import triad as j_triad  # noqa: E402

from repro_torch.carry import from_numpy, tensor  # noqa: E402
from repro_torch.core.dispatch import elementwise_call, elementwise_plain  # noqa: E402
from repro_torch.kernels.axpy.ops import axpy as p_axpy  # noqa: E402
from repro_torch.kernels.scale.ops import scale as p_scale  # noqa: E402
from repro_torch.kernels.spmv.ref import csr_spmv_ref  # noqa: E402
from repro_torch.kernels.spmv.ops import dense_to_bell as p_dense_to_bell  # noqa: E402
from repro_torch.kernels.spmv.ops import spmv as p_spmv  # noqa: E402
from repro_torch.kernels.spmv.spmv import bell_spmv, spmv_plain  # noqa: E402
from repro_torch.kernels.stencil.defs import suite as p_suite  # noqa: E402
from repro_torch.kernels.stencil.ops import stencil as p_stencil  # noqa: E402
from repro_torch.kernels.stencil.stencil import stencil_apply, stencil_plain  # noqa: E402
from repro_torch.kernels.triad.ops import triad as p_triad  # noqa: E402

ENGINES = ("vector", "matrix")
SHAPES = [(17,), (1024,), (300_000,), (33, 95)]
DTYPES = ("float32", "bfloat16")


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each value (8 significant bits)."""
    mag = np.maximum(np.abs(x.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_elementwise_close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).replace("torch.", "") == dtype
    g = got.float().numpy()
    w = want.astype(np.float32)
    if dtype == "bfloat16":
        assert np.all(np.abs(g - w) <= _bf16_ulp(w)), \
            f"max err {np.abs(g - w).max()}"
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def _elementwise_inputs(shape, dtype, n_arrays):
    rng = np.random.default_rng(0)
    arrs = [np.asarray(jnp.asarray(rng.standard_normal(shape), dtype))
            for _ in range(n_arrays)]
    return arrs, [tensor(a, "cpu") for a in arrs]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", ["scale", "triad", "axpy"])
def test_elementwise_plain_matches_reference(family, dtype, shape, engine):
    q = 2.5
    if family == "scale":
        (b,), (tb,) = _elementwise_inputs(shape, dtype, 1)
        want = j_scale(b, q, engine=engine)
        got = p_scale(tb, q, engine=engine, backend="plain")
    elif family == "triad":
        (b, c), (tb, tc) = _elementwise_inputs(shape, dtype, 2)
        want = j_triad(b, c, q, engine=engine)
        got = p_triad(tb, tc, q, engine=engine, backend="plain")
    else:
        (x, y), (tx, ty) = _elementwise_inputs(shape, dtype, 2)
        want = j_axpy(q, x, y, engine=engine)
        got = p_axpy(q, tx, ty, engine=engine, backend="plain")
    _assert_elementwise_close(got, want, dtype)


@pytest.mark.parametrize("tile", [{"block_rows": 128, "lanes": 512},
                                  {"block_rows": 512, "lanes": 1024}])
def test_elementwise_tile_config_accepted(tile):
    from repro_torch.kernels import registry
    op = registry.get("triad")
    (b, c), (tb, tc) = _elementwise_inputs((5000,), "float32", 2)
    got = op(tb, tc, 1.5, engine="vector", backend="plain", tile_config=tile)
    _assert_elementwise_close(got, j_triad(b, c, 1.5, engine="vector"),
                              "float32")
    with pytest.raises(ValueError, match="tile"):
        op(tb, tc, 1.5, backend="plain", tile_config={"warps": 4})


def _random_sparse(m, n, density, rng):
    a = rng.standard_normal((m, n)).astype(np.float32)
    return a * (rng.random((m, n)) < density)


SPMV_CASES = [(32, 256, 0.05), (64, 512, 0.01), (128, 384, 0.3),
              (8, 128, 1.0)]


@pytest.mark.parametrize("engine", ENGINES + ("auto",))
@pytest.mark.parametrize("m,n,density", SPMV_CASES)
def test_spmv_plain_matches_reference(engine, m, n, density):
    rng = np.random.default_rng(1)
    a = _random_sparse(m, n, density, rng)
    jbell = j_dense_to_bell(a, bm=8, bn=128)
    x = np.asarray(jnp.asarray(rng.standard_normal(n), jnp.float32))
    want = np.asarray(j_spmv(jbell, x, engine=engine))
    (pbell, px), _ = from_numpy((jbell, x), {}, device="cpu")
    got = p_spmv(pbell, px, engine=engine, backend="plain")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n,density", SPMV_CASES + [(16, 256, 0.0)])
def test_dense_to_bell_exact(m, n, density):
    rng = np.random.default_rng(2)
    a = _random_sparse(m, n, density, rng)
    jbell = j_dense_to_bell(a, bm=8, bn=128)
    pbell = p_dense_to_bell(a, bm=8, bn=128)
    np.testing.assert_array_equal(pbell.blocks.numpy(),
                                  np.asarray(jbell.blocks))
    np.testing.assert_array_equal(pbell.cols.numpy(), np.asarray(jbell.cols))
    assert pbell.cols.dtype == torch.int32 and pbell.shape == jbell.shape
    np.testing.assert_array_equal(pbell.todense().numpy(),
                                  np.asarray(jbell.todense()))
    x = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(
        (pbell.todense() @ torch.from_numpy(x)).numpy(),
        np.asarray(j_bell_matvec_ref(jbell, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_csr_oracle():
    rng = np.random.default_rng(3)
    a = _random_sparse(40, 64, 0.15, rng)
    rows, cols = np.nonzero(a)
    indptr = np.searchsorted(rows, np.arange(41)).astype(np.int32)
    x = rng.standard_normal(64).astype(np.float32)
    got = csr_spmv_ref(torch.from_numpy(indptr), torch.from_numpy(
        cols.astype(np.int32)), torch.from_numpy(a[rows, cols]),
        torch.from_numpy(x), m=40)
    np.testing.assert_allclose(got.numpy(), a @ x, rtol=1e-5, atol=1e-5)


STENCILS = sorted(j_suite())


@pytest.mark.parametrize("block_rows", [None, 1], ids=["default", "clamped"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", STENCILS)
def test_stencil_plain_matches_reference(name, engine, block_rows):
    jspec = j_suite()[name]
    steps = TABLE3_DEPTH[name]
    rng = np.random.default_rng(4)
    shape = (40, 70) if jspec.ndim == 2 else (12, 20, 34)
    u = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(j_stencil(u, jspec, steps=steps, engine=engine,
                                block_rows=block_rows))
    (pu, pspec), _ = from_numpy((u, jspec), {}, device="cpu")
    assert pspec == p_suite()[name]
    got = p_stencil(pu, pspec, steps=steps, engine=engine,
                    block_rows=block_rows, backend="plain")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", STENCILS)
def test_stencil_kernel_refuses_other_offset_orders(name):
    """The kernels are compiled for the offsets of defs.py's _star /
    _box_separable in their order (the order of the multiply-adds): every
    suite member is in it, and the launch wrapper refuses a reordered spec
    before it looks at the tensor or the card."""
    import dataclasses
    from repro_torch.kernels import _ext
    spec = p_suite()[name]
    assert spec.offsets == _ext.stencil_offsets(spec.ndim, spec.radius,
                                                spec.kind)
    bad = dataclasses.replace(spec, offsets=spec.offsets[::-1],
                              weights=spec.weights[::-1])
    u = torch.zeros((8,) * spec.ndim)
    with pytest.raises(ValueError, match="offsets"):
        _ext.stencil(u, bad, steps=1, engine="vector", block_rows=32)
    with pytest.raises(ValueError, match="card"):
        _ext.stencil(u, spec, steps=1, engine="vector", block_rows=32)


def test_stencil_halo_must_fit_block():
    spec = p_suite()["2d13pt"]
    u = torch.zeros(16, 16)
    with pytest.raises(ValueError, match="halo"):
        stencil_apply(u, spec, steps=2, block_rows=4, backend="plain")


# --------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_elementwise_kernel_matches_plain(card, dtype, engine):
    g = torch.Generator().manual_seed(0)
    for n in (17, 300_000, 33 * 95):
        m = torch.randn(n, generator=g).to(dtype).to(card)
        a = torch.randn(n, generator=g).to(dtype).to(card)
        for add in (None, a):
            got = elementwise_call("test", m, 1.5, add, engine=engine)
            want = elementwise_plain(m, 1.5, add, engine)
            assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_elementwise_grid_edges_match_plain(card, dtype, engine):
    """Bit for bit at the edges of the kernel's grid, for every tile of the
    space: one CTA's elements -/+ 1, one full wave of the card's resident
    CTAs and 8 elements more, odd sizes, and an input that starts 16 bytes
    into a larger tensor."""
    from repro_torch.kernels import _ext
    from repro_torch.kernels.elementwise_tuning import ELEMENTWISE_TILE_SPACE
    g = torch.Generator().manual_seed(7)
    per_chunk = 16 // torch.tensor([], dtype=dtype).element_size()
    props = torch.cuda.get_device_properties(card)
    wave = props.multi_processor_count * (
        props.max_threads_per_multi_processor // _ext.ELEMENTWISE_THREADS)
    cta = _ext.ELEMENTWISE_THREADS * per_chunk
    for has_add in (False, True):
        for shape in ((17,), (cta - 1,), (cta + 1,), (wave * cta,),
                      (wave * cta + 8,), (300_000,), (33, 95)):
            m = torch.randn(shape, generator=g).to(dtype).to(card)
            add = torch.randn(shape, generator=g).to(dtype).to(card) \
                if has_add else None
            want = elementwise_plain(m, 1.5, add, engine)
            for rows in ELEMENTWISE_TILE_SPACE["block_rows"]:
                for lanes in ELEMENTWISE_TILE_SPACE["lanes"]:
                    got = elementwise_call("test", m, 1.5, add, engine=engine,
                                           block_rows=rows, lanes=lanes)
                    assert torch.equal(got, want), (shape, has_add, rows,
                                                    lanes)
        big = torch.randn(300_000 + per_chunk, generator=g).to(dtype).to(card)
        m = big[per_chunk:]
        add = big[:-per_chunk] if has_add else None
        assert m.data_ptr() % 16 == 0
        assert torch.equal(elementwise_call("test", m, 1.5, add, engine=engine),
                           elementwise_plain(m, 1.5, add, engine))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
def test_card_spmv_kernel_matches_plain(card, engine):
    rng = np.random.default_rng(1)
    for m, n, density in SPMV_CASES:
        bell = p_dense_to_bell(torch.from_numpy(
            _random_sparse(m, n, density, rng)).to(card))
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(card)
        got = bell_spmv(bell.blocks, bell.cols, x, engine=engine)
        want = spmv_plain(bell.blocks, bell.cols, x, engine=engine)
        assert (got - want).abs().max().item() <= 1e-4
    # slot counts off the matrix kernel's ring depth (3) and warp count (4),
    # one block row, a repeated id, and out-of-range ids, which contribute
    # nothing (the plain version gets zero blocks at column 0 there)
    g = torch.Generator().manual_seed(6)
    for nbr, mb, ncb in ((1, 1, 1), (1, 7, 3), (5, 13, 4), (3, 2, 2)):
        blocks = torch.randn((nbr, mb, 8, 128), generator=g)
        cols = torch.randint(0, ncb, (nbr, mb), generator=g,
                             dtype=torch.int32)
        bad = torch.zeros((nbr, mb), dtype=torch.bool)
        if mb > 1:
            cols[:, 1] = cols[:, 0]
        if mb > 2:
            cols[0, 2], cols[-1, mb - 1] = ncb, -1
            bad[0, 2] = bad[-1, mb - 1] = True
        x = torch.randn(ncb * 128, generator=g)
        want = spmv_plain(blocks.masked_fill(bad[:, :, None, None], 0.0),
                          cols.masked_fill(bad, 0), x, engine=engine)
        got = bell_spmv(blocks.to(card), cols.to(card), x.to(card),
                        engine=engine)
        assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", STENCILS)
def test_card_stencil_kernel_matches_plain(card, name, engine):
    """Bit for bit: the kernels sum in the plain version's order.  The
    second shape per ndim has a trailing extent that is no multiple of 4
    (the 4-byte load path) and a leading one that no block divides."""
    spec = p_suite()[name]
    steps = TABLE3_DEPTH[name]
    shapes = [(130, 300), (77, 1001)] if spec.ndim == 2 else \
        [(40, 33, 70), (37, 29, 95)]
    g = torch.Generator().manual_seed(5)
    for shape in shapes:
        u = torch.randn(shape, generator=g).to(card)
        want = stencil_plain(u, spec, steps=steps, engine=engine)
        for br in (32, 128):
            got = stencil_apply(u, spec, steps=steps, engine=engine,
                                block_rows=br)
            assert torch.equal(got, want), (shape, br)
