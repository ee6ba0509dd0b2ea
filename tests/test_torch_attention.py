"""Flash-decode parity: the port's plain version against the JAX kernel.

The same seeded numpy inputs go through the reference's ``flash_decode``
(Pallas in interpret mode, as ``tests/test_flash_decode.py`` runs it)
and through the port's ``flash_decode`` with ``backend="plain"`` on CPU
tensors, the plain PyTorch version of the hand-written CUDA kernels.
Tolerances: float32 rtol = atol = 1e-5 (summation order); bfloat16
within one bfloat16 ulp.  Outputs are convex combinations of V rows, so
some elements cancel to near zero; there float32 summation error exceeds
a bf16 ulp of the element itself, and the ulp is taken at a floor of
1/256 of the output's largest magnitude.

The configs' head dims 112 and 160 are held the same way at kv_len
S - 16, 0, 1 and S, and every config that decodes through the kernels
passes their argument check at its full (G, Dh).

Tests marked ``gpu`` hold both CUDA kernels against the plain version on
the card; they skip where there is none.
"""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro.kernels.attention.flash_decode import flash_decode as j_flash  # noqa: E402
from repro.kernels.attention.ref import decode_attention_ref as j_ref  # noqa: E402

from repro_torch.carry import tensor  # noqa: E402
from repro_torch.kernels._ext import (  # noqa: E402
    CTAS_PER_SM, HEAD_DIMS, attention_launch, attention_ranges,
    attention_split, ctas_per_sm)
from repro_torch.kernels.attention.flash_decode import (  # noqa: E402
    flash_decode, flash_decode_plain)
from repro_torch.kernels.attention.ops import (  # noqa: E402
    _clamp_block_s, decode_attention)
from repro_torch.kernels.attention.ref import decode_attention_ref  # noqa: E402

ENGINES = ("vector", "matrix")
DTYPES = ("float32", "bfloat16")
#: (b, s, kh, g, dh, block_s): tests/test_flash_decode.py's sweep, then
#: Qwen3-MoE's 16 query heads per KV head and an odd group of 12 (the
#: kernels' head tile of 16)
SHAPES = [(1, 512, 2, 4, 64, 128), (2, 1024, 4, 8, 128, 256),
          (1, 256, 1, 1, 32, 64), (2, 512, 2, 16, 128, 128),
          (1, 256, 1, 12, 64, 64)]
#: unaligned serving cache lengths (S, kv_len), on (2, S, 1, 2, 16)
SERVING = [(12, 9), (24, 24), (56, 1)]
#: (G, Dh) of the configs' head dims that are not powers of two: Zamba2-7B's
#: 112 (G 1, and G 4), StableLM-2-12B's 160 (G 4, and G 16: the head tile
#: of 16)
CONFIG_DIMS = [(1, 112), (4, 112), (4, 160), (16, 160)]
#: their cache: (b, s, kh, block_s) and kv_len S - 16, 0, 1 and S
CONFIG_CACHE = (1, 128, 2, 64)
CONFIG_KV = [112, 0, 1, 128]
#: (G, Dh) of the head tile of 16 at every head dim the kernels take: its
#: smallest group (9) and its full one (16)
H16_DIMS = [(g, dh) for dh in HEAD_DIMS for g in (9, 16)]


def _mk(b, s, kh, g, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(shape), dtype)
            for shape in ((b, kh, g, dh), (b, s, kh, dh), (b, s, kh, dh))]


def _port(arrays):
    return [tensor(np.asarray(a), "cpu") for a in arrays]


def _assert_close(got, want, dtype):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        mag = np.maximum(np.abs(w), np.abs(w).max() / 256)
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp), np.abs(g - w).max()
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _check(b, s, kh, g, dh, block, kv_len, dtype, engine, seed=0):
    arrays = _mk(b, s, kh, g, dh, dtype, seed)
    want = j_flash(*arrays, kv_len, block_s=block, engine=engine,
                   interpret=True)
    got = flash_decode(*_port(arrays), kv_len, block_s=block, engine=engine,
                       backend="plain")
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,kh,g,dh,block", SHAPES)
def test_plain_matches_reference_kernel(b, s, kh, g, dh, block, dtype,
                                        engine):
    _check(b, s, kh, g, dh, block, s - 16, dtype, engine)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,kv_len", SERVING)
def test_plain_matches_reference_at_serving_lengths(s, kv_len, dtype, engine):
    _check(2, s, 1, 2, 16, _clamp_block_s(s, 512), kv_len, dtype, engine,
           seed=s)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_len", [0, 1, 512])
def test_plain_matches_reference_at_kv_len_edges(kv_len, dtype, engine):
    """kv_len = 0 is the mean of V (an all-masked block gives p = 1 at
    the -1e30 mask), 1 a single position, S the whole cache."""
    _check(1, 512, 2, 4, 64, 128, kv_len, dtype, engine)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_len", CONFIG_KV)
@pytest.mark.parametrize("g,dh", CONFIG_DIMS,
                         ids=[f"G{g}-Dh{dh}" for g, dh in CONFIG_DIMS])
def test_plain_matches_reference_at_config_head_dims(g, dh, kv_len, dtype,
                                                     engine):
    """Dh 112 and 160, which the kernels' lane maps split unevenly
    (28 and 40 elements per quarter of a row), at kv_len S - 16, 0, 1 and
    S; the module's tolerances."""
    b, s, kh, block = CONFIG_CACHE
    _check(b, s, kh, g, dh, block, kv_len, dtype, engine, seed=dh + g)


def test_kv_len_zero_is_the_mean_of_v():
    q, k, v = _port(_mk(1, 64, 2, 2, 16, "float32", 3))
    got = flash_decode(q, k, v, 0, block_s=16, backend="plain")
    want = v.mean(dim=1)[:, :, None, :].expand_as(got)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kv_len,seed", [(1, 0), (100, 1), (128, 2),
                                         (300, 3), (511, 4), (512, 5)])
def test_masked_tail_never_influences_the_result(kv_len, seed, engine):
    """tests/test_flash_decode.py's property: poison the masked tail."""
    q, k, v = _port(_mk(1, 512, 2, 2, 64, "float32", seed))
    got = flash_decode(q, k, v, kv_len, block_s=128, engine=engine,
                       backend="plain")
    k2, v2 = k.clone(), v.clone()
    k2[:, kv_len:] = 1e6
    v2[:, kv_len:] = -1e6
    got2 = flash_decode(q, k2, v2, kv_len, block_s=128, engine=engine,
                        backend="plain")
    torch.testing.assert_close(got, got2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_oracle_matches_reference_oracle(dtype):
    arrays = _mk(2, 96, 2, 4, 32, dtype, 9)
    want = j_ref(*arrays, 70)
    got = decode_attention_ref(*_port(arrays), 70)
    _assert_close(got, want, dtype)


def test_registry_route_clamps_block_to_a_divisor():
    """decode_attention with the default block on an unaligned cache."""
    q, k, v = _port(_mk(2, 12, 1, 2, 16, "float32", 12))
    got = decode_attention(q, k, v, 9, backend="plain")
    want = decode_attention_ref(q, k, v, 9)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,block_s,pairs,rows,nsplit", [
    (32768, 512, 32, 4096, 8),   # long cache: one long range per CTA slot
    (512, 512, 32, 64, 8),       # the model's cache: cut to fill the slots
    (12, 12, 2, 64, 1),          # short serving cache: one range
    (1024, 256, 8, 64, 16),
    (32768, 512, 512, 512, 64),  # the pairs fill the slots: block_s ranges
])
def test_split_covers_the_cache(s, block_s, pairs, rows, nsplit):
    assert attention_split(s, block_s, pairs, 264) == (rows, nsplit)
    assert rows * nsplit >= s > rows * (nsplit - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len", [-3, 0, 1, 15, 63, 64, 65, 511, 512,
                                    1000, 1023, 1024, 40000])
@pytest.mark.parametrize("s,block_s,pairs", [
    (32768, 512, 32), (512, 512, 32), (12, 12, 2), (1024, 256, 8),
    (32768, 512, 512)])
def test_ranges_cover_the_positions_read(s, block_s, pairs, kv_len, dtype):
    """The launched ranges cover exactly [0, min(kv_len, S)), all of S for
    kv_len <= 0, in ranges of block_s or of a multiple of 64 positions,
    no more CTAs than the card's slots unless the pairs alone exceed them;
    reading all of S with the same ranges adds ranges only past kv_len;
    for each engine at head tiles of 8 and 16."""
    for g, engine in itertools.product((4, 16), ENGINES):
        rows, nsplit, end = attention_ranges(s, block_s, pairs, 132, kv_len,
                                             dtype, g, engine, 128)
        slots = ctas_per_sm(dtype, g, engine) * 132
        assert end == (min(kv_len, s) if kv_len >= 1 else s)
        assert rows * (nsplit - 1) < end <= rows * nsplit
        assert rows == block_s or rows % 64 == 0
        assert pairs * nsplit <= max(slots, pairs * -(-end // block_s))
        assert -(-s // rows) >= nsplit


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kv_len", [1, 63, 64, 256])
def test_blocks_past_kv_len_change_no_bit(kv_len, dtype, engine):
    """Dropping the KV blocks that lie wholly past kv_len (p = 0, corr = 1
    in each) gives the full pass bit for bit: at kv_len 1, block_s - 1,
    block_s and S."""
    block_s, s = 64, 256
    q, k, v = _port(_mk(1, s, 2, 4, 32, dtype, kv_len))
    full = flash_decode_plain(q, k, v, kv_len, block_s=block_s,
                              engine=engine)
    kept = -(-kv_len // block_s) * block_s
    cut = flash_decode_plain(q, k[:, :kept].contiguous(),
                             v[:, :kept].contiguous(), kv_len,
                             block_s=block_s, engine=engine)
    assert torch.equal(cut, full)


def test_bfloat16_vector_kernel_above_g8_takes_two_ctas_per_sm():
    """The vector kernels at a head tile of 16 take the CTA slots per SM
    that their shared-memory layout fits: bfloat16 two, float32 one; the
    float32 matrix kernel there, which loads straight from global memory,
    two; every kernel at a head tile of 8 takes CTAS_PER_SM.  At
    Qwen3-MoE's decode shape the bfloat16 vector kernel launches twice its
    matrix kernel's ranges."""
    assert ctas_per_sm(torch.bfloat16, 16, "vector") == 2
    assert ctas_per_sm(torch.float32, 16, "vector") == 1
    assert ctas_per_sm(torch.float32, 16, "matrix") == 2
    for args in ((torch.bfloat16, 16, "matrix"), (torch.bfloat16, 8, "vector"),
                 (torch.float32, 8, "matrix"), (torch.float32, 8, "vector")):
        assert ctas_per_sm(*args) == CTAS_PER_SM[args[0]]
    pt = (32768, 512, 16, 132, 28672, torch.bfloat16, 16)
    assert attention_ranges(*pt, "vector", 128)[1] == \
        2 * attention_ranges(*pt, "matrix", 128)[1]


@pytest.mark.parametrize("g", range(9, 17))
def test_float32_vector_kernel_above_g8_takes_one_cta_per_sm(g):
    """The float32 vector kernel at a head tile of 16 (G 9..16) takes one
    CTA slot per SM, its matrix twin two, and the G <= 8 ring kernels one.
    At Qwen3-MoE's decode shape (B 4, KH 4, S 32768, kv_len 28672) on 132
    SMs the 16 pairs then get 8 ranges of 3584 positions, 128 CTAs in one
    wave, and the matrix kernel 16 ranges of 1792."""
    assert ctas_per_sm(torch.float32, g, "vector") == 1
    assert ctas_per_sm(torch.float32, g, "matrix") == 2
    assert ctas_per_sm(torch.float32, g - 8, "vector") == 1
    pt = (32768, 512, 16, 132, 28672, torch.float32, g)
    assert attention_ranges(*pt, "vector", 128) == (3584, 8, 28672)
    assert attention_ranges(*pt, "matrix", 128) == (1792, 16, 28672)


#: (name, B, KH, G, Dh, S, block_s, split_pairs, kv_lens, two-slot kv_lens):
#: every shape that runs the float32 ring kernels (G <= 8) in the main
#: path: the decode cells' layer call over ~28.7-29.1k positions, the stream
#: cells' K4 point, StableLM-2-12B's head dim, the short caches of
#: Zamba2-7B, SeamlessM4T-large-v2 and Qwen2-VL-72B, the examples' reduced
#: DeepSeek-7B (prompt 32 + 16 tokens), and a head shard of the stream point
#: (one of 4: 8 pairs cut as the unsharded call's 32); the last field names
#: the kv_lens whose ranges the planner cuts for two CTAs per SM
RING_PLANS = [
    ("mistral-decode-cell", 16, 8, 4, 128, 32768, 512, None,
     (28672, 28900, 29100, 32768), ()),
    ("stream-k4", 4, 8, 4, 128, 32768, 512, None, (28672,), ()),
    ("stablelm-12b", 4, 8, 4, 160, 32768, 512, None, (28672, 1), ()),
    ("zamba2-7b", 4, 32, 1, 112, 512, 512, None, (0, 1, 100, 511, 512), ()),
    ("seamless-m4t", 4, 16, 1, 64, 512, 512, None, (1, 256, 257, 512),
     (257, 512)),
    ("qwen2-vl-72b", 4, 8, 8, 128, 1536, 512, None, (1520, 1536), ()),
    ("deepseek-7b-reduced", 2, 4, 1, 32, 48, 48, None, (1, 32, 48), ()),
    ("stream-k4-shard", 4, 2, 4, 128, 32768, 512, 32, (28672,), ()),
]


@pytest.mark.parametrize("name,b,kh,g,dh,s,block_s,split,kv_lens,two",
                         RING_PLANS, ids=[p[0] for p in RING_PLANS])
def test_ring_kernel_plan_covers_each_position_once(name, b, kh, g, dh, s,
                                                    block_s, split, kv_lens,
                                                    two):
    """The float32 kernels at a head tile of 8 (the TMA-fed ring) take one
    CTA slot per SM on both engines, and at every shape of the main path
    that runs them the planned ranges cover [0, end) exactly once, each CTA
    one contiguous range, in one wave: one CTA per SM of an H100's 132, or
    two where the ranges cut for two leave each CTA a ring of two or more
    stages that two CTAs fit in an SM (SeamlessM4T's short cache)."""
    from repro_torch.kernels._ext import (CTA_RESERVED_BYTES,
                                          SM_SHARED_BYTES, attention_ring)
    pairs = b * kh if split is None else split
    for engine in ENGINES:
        assert ctas_per_sm(torch.float32, g, engine) == 1 == \
            CTAS_PER_SM[torch.float32]
        for kv_len in kv_lens:
            rows, nsplit, end = attention_ranges(
                s, block_s, pairs, 132, kv_len, torch.float32, g, engine, dh)
            assert end == (min(kv_len, s) if kv_len >= 1 else s)
            starts = [i * rows for i in range(nsplit)]
            stops = [min(a + rows, end) for a in starts]
            assert starts[0] == 0 and stops[-1] == end
            assert all(a < z for a, z in zip(starts, stops))
            assert all(z == a for z, a in zip(stops, starts[1:]))
            assert sum(z - a for a, z in zip(starts, stops)) == end
            per_sm = 2 if kv_len in two else 1
            assert (rows, nsplit) == attention_split(s, block_s, pairs,
                                                     per_sm * 132, end)
            assert pairs * nsplit <= per_sm * 132
            assert b * kh * nsplit <= per_sm * 132
            depth, nbytes = attention_ring(dh, -(-min(rows, end) // 64))
            assert per_sm * (nbytes + CTA_RESERVED_BYTES) <= SM_SHARED_BYTES
            assert per_sm == 1 or depth >= 2


def test_ring_shared_memory_fits_a_block_at_every_head_dim():
    """The ring's stages a warp and bytes (csrc/attention.cu's RingLayout):
    the fewest stages, at least two, that keep 48 KB of a CTA's tiles in
    flight beyond the ones being computed, within a block's 227 KB at every
    head dim; a range's tiles cap the depth; at Mistral-NeMo's Dh 128 two
    stages take 139,136 bytes."""
    from repro_torch.kernels._ext import attention_ring
    full = {dh: attention_ring(dh, 10 ** 6) for dh in HEAD_DIMS}
    assert all(d >= 2 and n <= 227 * 1024 for d, n in full.values())
    assert {dh: d for dh, (d, _) in full.items()} == {
        16: 7, 32: 4, 64: 3, 112: 2, 128: 2, 160: 2}
    assert all((d - 1) * 4 * 128 * dh >= 48 * 1024
               for dh, (d, _) in full.items())
    assert full[128][1] == 139136
    assert attention_ring(64, 2)[0] == 2 and attention_ring(64, 0)[0] == 1
    for dh in HEAD_DIMS:
        assert attention_ring(dh, 1)[1] < attention_ring(dh, 2)[1]


def test_kernel_takes_up_to_16_query_heads_per_kv_head():
    """The wrapper's argument check: G = 16 passes it (and stops at the
    card check on CPU tensors); G = 17 is refused naming the ROADMAP."""
    from repro_torch.kernels import _ext
    for g, match in ((16, "on the card"), (12, "on the card"),
                     (17, "ROADMAP.md Queue 2")):
        q, k, v = _port(_mk(1, 64, 1, g, 16, "float32"))
        with pytest.raises(ValueError, match=match):
            _ext.attention(q, k, v, 64, block_s=64, engine="vector")


def _k4_configs():
    """Every config whose decode attention runs through flash-decode (not
    MLA, not attention-free): (name, G, Dh) at full size."""
    from repro_torch.configs import ARCHS
    return [(c.name, c.n_heads // c.n_kv_heads, c.head_dim)
            for c in ARCHS.values()
            if not c.use_mla and not c.is_attention_free]


@pytest.mark.parametrize("name,g,dh", _k4_configs(),
                         ids=[n for n, _, _ in _k4_configs()])
def test_every_config_passes_the_kernels_argument_check(name, g, dh):
    """Each config's full (G, Dh) passes the wrapper's argument check: on
    CPU tensors it stops at the card check, not at a refusal."""
    from repro_torch.kernels import _ext
    assert dh in _ext.HEAD_DIMS and 1 <= g <= _ext.MAX_GROUP
    for dtype in DTYPES:
        q, k, v = _port(_mk(1, 64, 1, g, dh, dtype))
        with pytest.raises(ValueError, match="on the card"):
            _ext.attention(q, k, v, 64, block_s=64, engine="vector")


def test_kernel_refuses_other_head_dims_naming_the_roadmap():
    from repro_torch.kernels import _ext
    q, k, v = _port(_mk(1, 64, 1, 4, 96, "float32"))
    with pytest.raises(ValueError, match="ROADMAP.md Queue 2 item 7"):
        _ext.attention(q, k, v, 64, block_s=64, engine="vector")


def test_split_rejects_a_block_that_does_not_divide_s():
    with pytest.raises(ValueError, match="divide"):
        attention_split(100, 64, 1, 132)
    q, k, v = _port(_mk(1, 100, 1, 1, 16, "float32"))
    with pytest.raises(ValueError, match="divide"):
        flash_decode(q, k, v, 50, block_s=64, backend="plain")


# --------------------------------------------------------------------------
# on the card: both CUDA kernels against the plain version
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
def test_card_flash_decode_matches_plain(card, dtype, engine):
    cases = [(b, s, kh, g, dh, s - 16) for b, s, kh, g, dh, _ in SHAPES]
    cases += [(2, s, 1, 2, 16, kv) for s, kv in SERVING]
    cases += [(1, 512, 2, 4, 64, 0)]
    # 16 ranges of 64 positions at block_s 128: whole ranges past kv_len,
    # at G = 4 (head tile 8) and G = 16 (head tile 16)
    cases += [(2, 1024, 2, g, 128, kv) for g in (4, 16) for kv in
              (0, 1, 15, 16, 17, 63, 64, 65, 1023, 1024)]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for b, s, kh, g, dh, kv_len in cases:
        q, k, v = [t.to(dtype).to(card) for t in
                   _port(_mk(b, s, kh, g, dh, "float32", s))]
        for block in sorted({math.gcd(s, bs) for bs in (128, 256, 512)}):
            got = flash_decode(q, k, v, kv_len, block_s=block, engine=engine)
            want = flash_decode_plain(q, k, v, kv_len, block_s=block,
                                      engine=engine)
            _assert_close(got.cpu(), want.float().cpu().numpy(),
                          "bfloat16" if dtype == torch.bfloat16
                          else "float32")
            if kv_len >= 1:
                # bit for bit against reading every range and position
                rows = attention_ranges(s, block, b * kh, sms, kv_len,
                                        dtype, g, engine, dh)[0]
                full = attention_launch(q, k, v, kv_len, rows=rows,
                                        nsplit=-(-s // rows), end=s,
                                        engine=engine)
                assert torch.equal(got, full)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,dh", CONFIG_DIMS,
                         ids=[f"G{g}-Dh{dh}" for g, dh in CONFIG_DIMS])
def test_card_flash_decode_at_config_head_dims(card, g, dh, dtype, engine):
    """Dh 112 and 160 on the card against the plain version, over 16
    ranges of 64 positions at the kv_len edges, and bit for bit against
    reading every range and position."""
    b, s, kh, block = 2, 1024, 2, 128
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    q, k, v = [t.to(dtype).to(card) for t in
               _port(_mk(b, s, kh, g, dh, "float32", dh))]
    for kv_len in (0, 1, 15, 16, 17, 63, 64, 65, 1023, 1024):
        got = flash_decode(q, k, v, kv_len, block_s=block, engine=engine)
        want = flash_decode_plain(q, k, v, kv_len, block_s=block,
                                  engine=engine)
        _assert_close(got.cpu(), want.float().cpu().numpy(),
                      "bfloat16" if dtype == torch.bfloat16 else "float32")
        if kv_len >= 1:
            rows = attention_ranges(s, block, b * kh, sms, kv_len, dtype, g,
                                    engine, dh)[0]
            full = attention_launch(q, k, v, kv_len, rows=rows,
                                    nsplit=-(-s // rows), end=s,
                                    engine=engine)
            assert torch.equal(got, full)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,dh", H16_DIMS,
                         ids=[f"G{g}-Dh{dh}" for g, dh in H16_DIMS])
def test_card_head_tile_16_at_every_head_dim(card, g, dh, dtype, engine):
    """The head tile of 16 (the float32 and bfloat16 vector kernels of
    their own, the matrix kernels' two N tiles) at every head dim of
    HEAD_DIMS and G 9 and 16: against the plain version over 16 ranges of
    64 positions at the kv_len edges, and bit for bit against reading
    every range and position."""
    b, s, kh, block = 2, 1024, 2, 128
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    q, k, v = [t.to(dtype).to(card) for t in
               _port(_mk(b, s, kh, g, dh, "float32", g * dh))]
    for kv_len in (0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 1023, 1024):
        got = flash_decode(q, k, v, kv_len, block_s=block, engine=engine)
        want = flash_decode_plain(q, k, v, kv_len, block_s=block,
                                  engine=engine)
        _assert_close(got.cpu(), want.float().cpu().numpy(),
                      "bfloat16" if dtype == torch.bfloat16 else "float32")
        if kv_len >= 1:
            rows = attention_ranges(s, block, b * kh, sms, kv_len, dtype, g,
                                    engine, dh)[0]
            full = attention_launch(q, k, v, kv_len, rows=rows,
                                    nsplit=-(-s // rows), end=s,
                                    engine=engine)
            assert torch.equal(got, full)


#: G of the float32 ring kernels (head tile 8) that the card tests sweep
RING_GROUPS = (1, 2, 4, 8)


def _ring_launches(engine):
    from repro_torch.kernels import _ext
    return _ext.LAUNCHES.get(f"attention_ring_{engine}", 0)


def _check_ring(q, k, v, kv_len, block, engine, sms, launch=None):
    """One call of the float32 ring kernel against the plain version (the
    module's tolerance), counted once under attention_ring_<engine>; for
    kv_len >= 1 also bit for bit against reading every range and position
    with the same ranges.  ``launch`` = (rows, nsplit, end) calls
    attention_launch with those ranges instead of the planner's."""
    before = _ring_launches(engine)
    if launch is None:
        got = flash_decode(q, k, v, kv_len, block_s=block, engine=engine)
    else:
        rows, nsplit, end = launch
        got = attention_launch(q, k, v, kv_len, rows=rows, nsplit=nsplit,
                               end=end, engine=engine)
    assert _ring_launches(engine) == before + 1
    want = flash_decode_plain(q, k, v, kv_len, block_s=block, engine=engine)
    _assert_close(got.cpu(), want.cpu().numpy(), "float32")
    if kv_len >= 1 and launch is None:
        b, kh, g, dh = q.shape
        s = k.shape[1]
        rows = attention_ranges(s, block, b * kh, sms, kv_len, torch.float32,
                                g, engine, dh)[0]
        full = attention_launch(q, k, v, kv_len, rows=rows,
                                nsplit=-(-s // rows), end=s, engine=engine)
        assert torch.equal(got, full)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("g", RING_GROUPS)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_card_float32_ring_kernel_matches_plain(card, dh, g, engine):
    """The float32 ring kernel at every head dim and G 1, 2, 4 and 8: at
    kv_len 0, 1, 15, 16, 17, a range boundary - 1 / + 1 (ranges of 64
    positions), S - 1 and S; then one range over the whole cache and
    ranges of 1000 positions (a ragged tile at a range's end), where each
    warp walks 16 tiles and reuses every stage of its ring."""
    b, s, kh, block = 2, 1024, 2, 128
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    q, k, v = [t.to(card) for t in
               _port(_mk(b, s, kh, g, dh, "float32", 7 * g + dh))]
    for kv_len in (0, 1, 15, 16, 17, 63, 64, 65, s - 1, s):
        _check_ring(q, k, v, kv_len, block, engine, sms)
    for rows, end in ((s, s - 5), (1000, s)):
        _check_ring(q, k, v, s - 5, block, engine, sms,
                    launch=(rows, -(-end // rows), end))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("b,kh,g,dh", [(4, 32, 1, 112), (4, 16, 1, 64)],
                         ids=["zamba2-7b", "seamless-m4t"])
def test_card_float32_ring_kernel_on_short_caches(card, b, kh, g, dh,
                                                  engine):
    """Zamba2-7B's and SeamlessM4T's decode shapes over a cache of 512: the
    ranges hold fewer tiles a warp than a full ring (at kv_len 100 two,
    SeamlessM4T's 256-position ranges four of Dh 64's five stages), so the
    ring is cut to them; against the plain version at the kv_len edges."""
    s, block = 512, 512
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    q, k, v = [t.to(card) for t in
               _port(_mk(b, s, kh, g, dh, "float32", dh))]
    for kv_len in (0, 1, 15, 16, 17, 100, 255, 256, 257, s - 1, s):
        _check_ring(q, k, v, kv_len, block, engine, sms)
