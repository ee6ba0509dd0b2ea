"""MLA decode's latent attention (``models.attention.latent_decode``) on
the CPU: the batched products over the valid positions against the
absorbed einsum path they replaced (the whole cache, the positions past
kv_len masked), against the exact softmax in float64, the tokens of a
step as independent rows, the decode step against the JAX reference, the
positions past kv_len never seen, and the decode branch's call.

Tolerances: float32 sums over fewer positions, or in another order, than
the masked einsums: 1e-6 relative to the output's scale (2e-6 absolute
on outputs of order one); the decode step against the reference 1e-5,
as ``tests/test_torch_models.py`` holds MLA; float64 inputs against
the exact formula in float64, the softmax being float32's, as against
the einsums; a step's tokens against one call a token, bit
for bit is not asked (the products' shapes differ), 1e-6.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as j_configs  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.models import attention as p_attn  # noqa: E402
from repro_torch.models.attention import latent_decode  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.obs.trace import capture  # noqa: E402

#: the cache length of the small cases
S_MAX = 72
#: kv_len: one position, a tile less one, a tile, a tile and one, the
#: whole cache
KV_LENS = [1, 31, 32, 33, S_MAX]


def _draw(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _inputs(b, s, h, r, rd, seed=0):
    return (_draw(b, s, h, r, seed=seed), _draw(b, s, h, rd, seed=seed + 1),
            _draw(b, S_MAX, r, seed=seed + 2),
            _draw(b, S_MAX, rd, seed=seed + 3))


def _masked_full(q_lat, q_rope, lat, kr, kv_len, scale):
    """The decode branch's arithmetic before: scores over the
    whole cache, the positions past kv_len masked to -1e30."""
    sc = (torch.einsum("bqhr,bkr->bhqk", q_lat, lat)
          + torch.einsum("bqhd,bkd->bhqk", q_rope, kr)).float() * scale
    valid = torch.arange(lat.shape[1]) < kv_len
    sc = torch.where(valid, sc, p_attn.NEG_INF)
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bkr->bqhr", w, lat)


@pytest.mark.parametrize("kv_len", KV_LENS)
@pytest.mark.parametrize("h,s", [(16, 1), (16, 2), (128, 1), (128, 2)])
def test_plain_matches_the_masked_einsums(h, s, kv_len):
    r, rd = 64, 16
    args = _inputs(2, s, h, r, rd, seed=h + s)
    scale = 1.0 / math.sqrt(48.0)
    got = latent_decode(*args, kv_len, scale)
    want = _masked_full(*args, kv_len, scale)
    assert got.shape == (2, s, h, r) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("kv_len", [1, 31, 32, 33])
def test_positions_past_kv_len_are_never_seen(kv_len):
    """NaN written into both caches at and beyond kv_len: the output is
    finite and the same, bit for bit."""
    args = _inputs(2, 1, 16, 64, 16, seed=5)
    clean = latent_decode(*args, kv_len, 0.125)
    lat, kr = args[2].clone(), args[3].clone()
    lat[:, kv_len:] = float("nan")
    kr[:, kv_len:] = float("nan")
    dirty = latent_decode(args[0], args[1], lat, kr, kv_len, 0.125)
    assert torch.isfinite(dirty).all()
    assert torch.equal(dirty, clean)


def _pair(h):
    """The reduced DeepSeek-V2-Lite (latent 64, rope 16) at ``h`` heads,
    the reference's config and the port's."""
    return tuple(dataclasses.replace(mod.reduced(mod.get_arch(
        "deepseek-v2-lite-16b")), n_heads=h, n_kv_heads=h)
        for mod in (j_configs, p_configs))


def _block(tree):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = torch.from_numpy(np.asarray(v).copy())
    walk(tree, "")
    return p_lm.Block(flat)


@pytest.mark.parametrize("kv_len", [2, 32, 33, S_MAX])
@pytest.mark.parametrize("h,s", [(16, 1), (16, 2), (128, 1), (128, 2)])
def test_decode_step_matches_reference(h, s, kv_len):
    """One absorbed decode step of s tokens at cache_index kv_len - s
    against the reference's, on the same latent caches: the output and
    the caches written in place."""
    j, p = _pair(h)
    params = jax.tree.map(np.asarray, j_attn._init_mla(jax.random.key(3), j))
    b, idx = 2, kv_len - s
    lat = _draw(b, S_MAX, p.kv_lora_rank, seed=11).numpy()
    kr = _draw(b, S_MAX, p.qk_rope_dim, seed=12).numpy()
    x = _draw(b, s, p.d_model, seed=13).numpy() * 0.5
    pos = np.broadcast_to(np.arange(idx, kv_len, dtype=np.int32), (b, s))
    want, jc = j_attn.mla_attention(
        params, jnp.asarray(x), j, positions=jnp.asarray(pos),
        cache={"latent": jnp.asarray(lat), "k_rope": jnp.asarray(kr)},
        cache_index=idx)
    pc = {"latent": torch.from_numpy(lat.copy()),
          "k_rope": torch.from_numpy(kr.copy())}
    got, pc = p_attn.mla_attention(
        _block(params), torch.from_numpy(x), p,
        positions=torch.from_numpy(pos.copy()), cache=pc, cache_index=idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for k in ("latent", "k_rope"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-5, rtol=1e-5)


def test_decode_branch_goes_through_latent_decode(monkeypatch):
    """Each decode call runs ``latent_decode`` once, over cache_index + s
    positions, inside ``model.mla``; a prefill runs it never."""
    j, p = _pair(16)
    params = jax.tree.map(np.asarray, j_attn._init_mla(jax.random.key(4), j))
    calls = []

    def spy(q_lat, q_rope, latent, k_rope, kv_len, scale):
        calls.append((tuple(q_lat.shape), kv_len))
        return latent_decode(q_lat, q_rope, latent, k_rope, kv_len, scale)
    monkeypatch.setattr(p_attn, "latent_decode", spy)
    blk = _block(params)
    pos = torch.arange(7, dtype=torch.int32).expand(2, 7)
    _, cache = p_attn.mla_attention(blk, _draw(2, 5, p.d_model, seed=3), p,
                                    positions=pos[:, :5])
    assert calls == []
    cache = p_lm.pad_caches(cache, S_MAX)
    with capture() as view:
        p_attn.mla_attention(blk, _draw(2, 2, p.d_model, seed=4), p,
                             positions=pos[:, 5:], cache=cache,
                             cache_index=5)
    assert calls == [((2, 2, 16, 64), 7)]
    assert [e.name for e in view.events] == ["model.mla"]


@pytest.mark.parametrize("kv_len", [1, 31, 33, 50, S_MAX])
def test_float64_inputs_match_the_exact_softmax(kv_len):
    """Against the formula in float64: the scores over [0, kv_len) alone,
    exp normalised by hand.  The softmax runs in float32 whatever the
    inputs' type, so within float32 rounding; the output keeps the
    inputs' type."""
    b, s, h, r, rd = 2, 2, 8, 32, 8
    q_lat, q_rope, lat, kr = [a.double() for a in
                              _inputs(b, s, h, r, rd, seed=kv_len)]
    got = latent_decode(q_lat, q_rope, lat, kr, kv_len, 0.2)
    sc = (torch.einsum("bqhr,bkr->bqhk", q_lat, lat[:, :kv_len])
          + torch.einsum("bqhd,bkd->bqhk", q_rope, kr[:, :kv_len])) * 0.2
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    want = torch.einsum("bqhk,bkr->bqhr", e / e.sum(-1, keepdim=True),
                        lat[:, :kv_len])
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("h", [16, 128])
def test_tokens_of_a_step_are_independent_rows(h):
    """The s tokens of a step fold into the rows: each token's output is
    that of a call with it alone, over the same positions."""
    q_lat, q_rope, lat, kr = _inputs(2, 3, h, 64, 16, seed=h)
    got = latent_decode(q_lat, q_rope, lat, kr, 40, 0.125)
    for t in range(3):
        one = latent_decode(q_lat[:, t:t + 1], q_rope[:, t:t + 1], lat, kr,
                            40, 0.125)
        torch.testing.assert_close(got[:, t:t + 1], one, atol=1e-6,
                                   rtol=1e-6)
