"""The elementwise kernel's grid, checked without a card.

``repro_torch.kernels._ext.elementwise_grid`` gives the CUDA kernel one CTA
per 256 16-byte chunks, one chunk per thread.  These tests hold it to its
contract at the edges (empty and tiny arrays, one CTA's chunks -/+ 1
element, one full wave of an H100's 1,056 resident CTAs and 8 elements
more, the STREAM bench sizes): every chunk covered exactly once, at least
one CTA for n > 0, no more CTAs than chunks, no CTA without work.  The
kernel's indexing (thread i of CTA j on chunk 256 j + i, a warp leaving as
a whole when its row starts past the last chunk, lanes past the array
masked) is replayed in numpy at small sizes.  The tile space stays
accepted and does not change a result.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _ext, registry  # noqa: E402
from repro_torch.kernels.elementwise_tuning import ELEMENTWISE_TILE_SPACE  # noqa: E402

DTYPES = {"float32": 4, "bfloat16": 2}
#: CTAs an H100 SXM holds at once: 132 SMs x 8 CTAs of 256 threads.
WAVE = 132 * 8
#: The sizes at which the grid is checked: "cta" is one CTA's elements,
#: "wave" one full wave of the card's resident CTAs.
SIZES = ("0", "1", "17", "cta-1", "cta", "cta+1", "wave", "wave+8", "2^26",
         "2^27")
TILES = [{"block_rows": r, "lanes": w}
         for r in ELEMENTWISE_TILE_SPACE["block_rows"]
         for w in ELEMENTWISE_TILE_SPACE["lanes"]]


def _n(size: str, elem_bytes: int) -> int:
    cta = _ext.ELEMENTWISE_THREADS * (16 // elem_bytes)
    return {"0": 0, "1": 1, "17": 17, "cta-1": cta - 1, "cta": cta,
            "cta+1": cta + 1, "wave": WAVE * cta, "wave+8": WAVE * cta + 8,
            "2^26": 2**26, "2^27": 2**27}[size]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_elementwise_grid_covers_each_chunk_once(dtype, size):
    esize = DTYPES[dtype]
    n = _n(size, esize)
    chunks = -(-n * esize // 16)
    grid = _ext.elementwise_grid(n, esize)
    if n == 0:
        assert grid == 0
        return
    threads = _ext.ELEMENTWISE_THREADS
    assert 1 <= grid <= chunks
    # CTA j takes [256 j, min(256 j + 256, chunks)): the ranges tile
    # [0, chunks) end to end, and the last one is not empty
    starts = np.arange(grid) * threads
    ends = np.minimum(starts + threads, chunks)
    assert starts[0] == 0 and ends[-1] == chunks
    assert (ends > starts).all() and (ends[:-1] == starts[1:]).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_elementwise_grid_at_the_bench_points(dtype):
    """At STREAM size (256 MiB per array) every CTA is full: 65,536 CTAs,
    62 full waves of an H100 and a partial one."""
    n = 2**26 if dtype == "float32" else 2**27
    grid = _ext.elementwise_grid(n, DTYPES[dtype])
    assert grid == 2**16
    assert n * DTYPES[dtype] == grid * _ext.ELEMENTWISE_THREADS * 16
    assert grid // WAVE == 62


def _walk(n: int, elem_bytes: int) -> np.ndarray:
    """How often the kernel stores each chunk, replayed: thread i of CTA j
    on chunk 256 j + i; a warp whose row of 32 chunks starts at or past the
    last chunk leaves; lanes past the array store nothing."""
    chunks = -(-n * elem_bytes // 16)
    stores = np.zeros(chunks, dtype=np.int64)
    for cta in range(_ext.elementwise_grid(n, elem_bytes)):
        for tid in range(_ext.ELEMENTWISE_THREADS):
            row = cta * _ext.ELEMENTWISE_THREADS + (tid & ~31)
            if row >= chunks:
                continue
            c = row + (tid & 31)
            if c < chunks:
                stores[c] += 1
    return stores


@pytest.mark.parametrize("size", ["1", "17", "cta-1", "cta", "cta+1",
                                  "wave", "wave+8"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_elementwise_kernel_walk_stores_each_chunk_once(dtype, size):
    n = _n(size, DTYPES[dtype])
    if size.startswith("wave"):
        # the same indexing at a tenth of the wave keeps the replay short
        n //= 10
    assert (_walk(n, DTYPES[dtype]) == 1).all()


def test_elementwise_grid_refuses_bad_arguments():
    with pytest.raises(ValueError):
        _ext.elementwise_grid(-1, 4)
    with pytest.raises(ValueError):
        _ext.elementwise_grid(100, 8)


@pytest.mark.parametrize("tile", TILES,
                         ids=[f"{t['block_rows']}x{t['lanes']}"
                              for t in TILES])
@pytest.mark.parametrize("family", ["scale", "triad", "axpy"])
def test_every_tile_of_the_space_is_accepted_and_changes_nothing(family,
                                                                 tile):
    op = registry.get(family)
    args, _ = op.make_inputs(np.random.default_rng(0), 5000, "float32",
                             device="cpu")
    for engine in ("vector", "matrix"):
        got = op(*args, engine=engine, backend="plain", tile_config=tile)
        want = op(*args, engine=engine, backend="plain")
        assert torch.equal(got, want)
