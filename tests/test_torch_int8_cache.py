"""The int8 KV cache: the port against the reference.

``make_cache`` / ``init_caches`` at int8 (k and v as int8, a float32
scale per position and KV head; MLA's latents in bfloat16 without
scales; an encoder-decoder's cross K / V as int8 zeros without scales),
the quantization of new rows (``_int8_cache_update``), and decode steps
from an int8 cache with the reference's weights carried bit for bit.
The reference runs on the CPU at float32 (its dense decode path); the
port on the CPU, through both its dense path and the flash-decode op's
plain version.

Tolerances: the quantized rows and their scales bit for bit when both
packages quantize the same float32 rows.  In a decode step each package
projects its own k / v (float32 matmuls summing in different orders), so
the caches written there agree in their scales within 2e-6 relative (a
few float32 ulps) and in their int8 entries within one step, on under 1%
of them (a row on a rounding boundary); the logits within 1e-5 (atol) +
1e-5 |b|.
Tests marked ``gpu`` run the int8 step through the flash-decode kernel
on the card against the dense path, 1e-4 + 1e-3 |b| (the model tier).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro import configs as j_configs  # noqa: E402
from repro.data.synthetic import make_batch as j_make_batch  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.carry import params_from_numpy  # noqa: E402
from repro_torch.models import attention as p_attn  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

#: One config per cache layout: dense GQA, MLA (bfloat16 latents), the
#: hybrid's per-super-block caches, the encoder-decoder's cross K / V.
LAYOUTS = ("mistral-nemo-12b", "deepseek-v2-lite-16b", "zamba2-7b",
           "seamless-m4t-large-v2")
#: Decode from an int8 cache: dense, MoE (GQA at G 16 in full; MLA) and
#: the hybrid.
DECODE = ("mistral-nemo-12b", "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b",
          "zamba2-7b")
STEPS, MAX_LEN = 4, 8


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("name", LAYOUTS)
def test_int8_caches_have_the_reference_layout(name):
    jcfg = j_configs.reduced(j_configs.get_arch(name))
    pcfg = p_configs.reduced(p_configs.get_arch(name))
    want = _flat(j_lm.init_caches(jcfg, 2, 16, dtype=jnp.int8,
                                  enc_len=12 if jcfg.enc_dec else None))
    got = _flat(p_lm.init_caches(pcfg, 2, 16, dtype=torch.int8,
                                 device="cpu",
                                 enc_len=12 if pcfg.enc_dec else None))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).split(".")[-1] == str(w.dtype), key
        assert not g.any(), key
    one = p_attn.make_cache(pcfg, 2, 16, torch.int8, "cpu")
    ref = j_attn.make_cache(jcfg, 2, 16, jnp.int8)
    assert {k: tuple(v.shape) for k, v in one.items()} == \
        {k: v.shape for k, v in ref.items()}


def _rows(case):
    """(B, S, KH, Dh) float32 rows: seeded normals; rows of zeros (the
    1e-8 floor); rows whose quotients are exact .5 ties."""
    rng = np.random.default_rng(7)
    if case == "normal":
        return rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    x = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    if case == "zeros":
        x[0, 1] = 0.0
        x[1, :, 1] = 0.0
        return x
    # max |x| = 127 -> scale 1: every x / scale is the .5 value itself
    x[:] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5],
                    np.float32)
    x[1] *= -1
    return x


@pytest.mark.parametrize("case", ["normal", "zeros", "ties"])
def test_int8_cache_update_is_bit_equal(case):
    k, v = _rows(case), _rows(case)[..., ::-1].copy() * 0.25
    b, s, kh, dh = k.shape
    jcfg, cfg = (dataclasses.replace(c.reduced(c.get_arch(
        "mistral-nemo-12b")), n_kv_heads=kh, head_dim=dh)
        for c in (j_configs, p_configs))
    at = 2
    want = j_attn._int8_cache_update(
        j_attn.make_cache(jcfg, b, s + 4, jnp.int8), jnp.asarray(k),
        jnp.asarray(v), at)
    got = p_attn.make_cache(cfg, b, s + 4, torch.int8, "cpu")
    out = p_attn._int8_cache_update(got, torch.from_numpy(k),
                                    torch.from_numpy(v), at)
    assert out is got                          # written in place
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    if case == "zeros":
        assert got["k_scale"][0, at + 1].eq(1e-8).all()
    if case == "ties":
        # round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126
        assert got["k"][0, at, 0].tolist() == [127, 0, 2, 2, 0, -2, 126,
                                              -126]


def _decode_pair(name):
    jcfg = j_configs.reduced(j_configs.get_arch(name))
    pcfg = p_configs.reduced(p_configs.get_arch(name))
    if jcfg.n_experts:
        # capacity drops exist only in the batched pass: lift them, as
        # the reference's own decode-vs-forward test does
        jcfg = dataclasses.replace(jcfg, capacity_factor=64.0)
        pcfg = dataclasses.replace(pcfg, capacity_factor=64.0)
    params = j_lm.init_params(jcfg, jax.random.key(0))
    return jcfg, pcfg, params


@pytest.mark.parametrize("impl", ["dense", "registry"])
@pytest.mark.parametrize("name", DECODE)
def test_decode_from_int8_cache_matches_reference(name, impl):
    jcfg, pcfg, params = _decode_pair(name)
    pcfg = dataclasses.replace(pcfg, decode_attention_impl=impl)
    p = params_from_numpy(jax.tree.map(np.asarray, params), pcfg,
                          device="cpu")
    tokens = np.array(j_make_batch(jcfg, 2, STEPS, seed=3)["tokens"])
    step = jax.jit(lambda prm, tok, c, i: j_lm.decode_step(
        prm, jcfg, tok, c, i, dtype=jnp.float32))
    jc = j_lm.init_caches(jcfg, 2, MAX_LEN, dtype=jnp.int8)
    pc = p_lm.init_caches(pcfg, 2, MAX_LEN, dtype=torch.int8, device="cpu")
    with torch.no_grad():
        for t in range(STEPS):
            want, jc = step(params, tokens[:, t:t + 1], jc, jnp.int32(t))
            got, pc = p_lm.decode_step(p, pcfg,
                                       torch.from_numpy(tokens[:, t:t + 1]),
                                       pc, t, dtype=torch.float32)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5,
                                       err_msg=f"step {t}")
    want_c, got_c = _flat(jax.tree.map(np.asarray, jc)), _flat(pc)
    assert sorted(got_c) == sorted(want_c)
    for key, w in want_c.items():
        g = got_c[key].float().numpy() if got_c[key].dtype == \
            torch.bfloat16 else got_c[key].numpy()
        w = w.astype(np.float32) if w.dtype.name == "bfloat16" else w
        if key.endswith(("/k", "/v")) and w.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, key
            assert (diff > 0).mean() < 0.01, key
        elif key.endswith("_scale"):
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=0,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("impl", ["dense", "registry"])
def test_int8_step_attends_to_the_dequantized_cache(impl):
    """A step on an int8 cache equals a step on the float cache holding
    k * scale of every row, its own new row included: the dequantization
    covers the whole cache, before the kernel or the dense path reads
    it."""
    cfg = dataclasses.replace(
        p_configs.reduced(p_configs.get_arch("mistral-nemo-12b")),
        n_kv_heads=2, decode_attention_impl=impl)
    g = torch.Generator().manual_seed(0)
    b, kh, dh, at = 2, cfg.n_kv_heads, cfg.head_dim, 5
    cache = p_attn.make_cache(cfg, b, MAX_LEN, torch.int8, "cpu")
    p_attn._int8_cache_update(cache, torch.randn((b, at, kh, dh),
                                                 generator=g) * 2,
                              torch.randn((b, at, kh, dh), generator=g), 0)
    q = torch.randn((b, 1, cfg.n_heads, dh), generator=g)
    k, v = (torch.randn((b, 1, kh, dh), generator=g) for _ in range(2))
    pos = torch.full((b, 1), at, dtype=torch.int32)
    got = p_attn._attend_cache(q, k, v, cache, at, cfg, pos)
    deq = {n: cache[n] * cache[f"{n}_scale"][..., None] for n in ("k", "v")}
    new = {n: deq[n][:, at:at + 1].clone() for n in ("k", "v")}
    want = p_attn._attend_cache(q, new["k"], new["v"], deq, at, cfg, pos)
    assert torch.equal(got, want)


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
@pytest.mark.parametrize("engine", ["vector", "matrix"])
def test_card_int8_step_through_k4_matches_dense(card, engine):
    """On the card, decode steps from an int8 cache launch the engine's
    flash-decode kernel once per layer and step, the other engine's
    never, and equal the dense path on the same int8 caches."""
    from repro_torch.kernels import _ext
    from repro_torch.models.engine import DecodeEngine
    other = "matrix" if engine == "vector" else "vector"
    cfg = dataclasses.replace(
        p_configs.reduced(p_configs.get_arch("mistral-nemo-12b")),
        n_kv_heads=2)
    eng = DecodeEngine(cfg, max_batch=2, prompt_len=6, max_gen=4,
                       dtype=torch.float32, engine=engine, device=card)
    ref = DecodeEngine(cfg, max_batch=2, prompt_len=6, max_gen=4,
                       dtype=torch.float32, engine=engine,
                       attention_impl="dense", params=eng.params,
                       device=card)
    batch = eng.make_prompt_batch(seed=4)
    _, floats = eng.prefill(batch)
    caches = p_lm.init_caches(cfg, 2, eng.max_len, dtype=torch.int8,
                              device=card)
    for i in range(cfg.n_layers):
        p_attn._int8_cache_update(
            {n: c[i] for n, c in caches["attn"].items()},
            floats["attn"]["k"][i, :, :6], floats["attn"]["v"][i, :, :6], 0)
    twin = eng.cache_state(caches)
    tok = batch["tokens"][:, -1:]
    _ext.reset_launches()
    for at in range(6, 10):
        got, caches = eng.decode_step(tok, caches, at)
        want, twin = ref.decode_step(tok, twin, at)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
        tok = torch.argmax(got[:, 0], dim=-1)[:, None]
    assert _ext.LAUNCHES.get(f"attention_{engine}", 0) == cfg.n_layers * 4
    assert _ext.LAUNCHES.get(f"attention_{other}", 0) == 0
