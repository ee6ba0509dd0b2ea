"""The vision frontend and M-RoPE (Qwen2-VL-72B): the port against the
reference.

The frontend stub (patch embeddings through ``frontend.proj`` / ``bias``
in place of the first ``frontend_len`` positions), M-RoPE's (3, B, S)
positions at prefill and decode, the forward pass and ``DecodeEngine``
on both flash-decode engines and both ``attention_impl``s.  The
reference runs as its own tests run it (``jax_platform_name=cpu``,
Pallas flash-decode in interpret mode) at float32; the port runs on the
CPU with the kernels' plain versions, on the reference's own weights
carried by ``carry.params_from_numpy`` bit for bit, at ``reduced()`` size
(``frontend_len`` 8, ``frontend_dim`` 64, M-RoPE sections (4, 6, 6)).

Tolerance: |a - b| <= 1e-4 + 1e-3 |b| (the model tier of
``tests/test_model_engine.py``); batches and greedy tokens exactly equal.
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
from repro.models import lm as j_lm  # noqa: E402
from repro.models.engine import DecodeEngine as JEngine  # noqa: E402

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.carry import params_from_numpy  # noqa: E402
from repro_torch.data.synthetic import make_batch as p_make_batch  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.models.engine import DecodeEngine as PEngine  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

NAME = "qwen2-vl-72b"
ATOL, RTOL = 1e-4, 1e-3
#: A prompt of the reduced config's 8 patch positions and 4 of text.
ENGINE_KW = dict(max_batch=2, prompt_len=12, max_gen=4, seed=0)
ENGINES = [(e, impl) for e in ("vector", "matrix")
           for impl in ("registry", "dense")]
ENGINE_IDS = [f"{e}-{impl}" for e, impl in ENGINES]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


_MODEL = {}


def _model():
    """The reference's reduced weights and the port's carried copy."""
    if not _MODEL:
        j = j_configs.reduced(j_configs.get_arch(NAME))
        p = p_configs.reduced(p_configs.get_arch(NAME))
        params = j_lm.init_params(j, jax.random.key(0))
        _MODEL.update(j=j, p=p, jp=params, pp=params_from_numpy(
            jax.tree.map(np.asarray, params), p, device="cpu"))
    return _MODEL["j"], _MODEL["p"], _MODEL["jp"], _MODEL["pp"]


def _batches(b, s, seed):
    j, p, _, _ = _model()
    return (j_make_batch(j, b, s, seed=seed),
            p_make_batch(p, b, s, seed=seed, device="cpu"))


def test_make_batch_vision_embeds_and_loss_mask_bit_for_bit():
    """``vision_embeds`` (B, frontend_len, frontend_dim) float32 drawn
    after the tokens, and the loss mask zero over the patch positions:
    every leaf equals the reference's."""
    j, p, _, _ = _model()
    jb, pb = _batches(3, 13, seed=11)
    assert sorted(pb) == sorted(jb)
    assert tuple(pb["vision_embeds"].shape) == (3, p.frontend_len,
                                                p.frontend_dim)
    for k in jb:
        assert np.array_equal(pb[k].numpy(), np.asarray(jb[k])), k
    assert not pb["loss_mask"][:, :p.frontend_len].any()
    assert pb["loss_mask"][:, p.frontend_len:].all()


def test_embed_inputs_match_reference():
    """The patch embeddings through the frontend replace the first
    ``frontend_len`` positions; the text's embeddings follow."""
    j, p, jp, pp = _model()
    jb, pb = _batches(2, 12, seed=3)
    want = j_lm._embed_inputs(jp, j, jb, jnp.float32)
    got = p_lm._embed_inputs(pp, p, pb, torch.float32)
    _close(got, want)
    text = pp.embed[pb["tokens"][:, p.frontend_len:].long()]
    assert torch.equal(got[:, p.frontend_len:], text)


def test_mrope_positions_match_reference():
    """(3, B, S): the temporal, height and width streams, all equal."""
    j, p, _, _ = _model()
    want = j_lm._positions(j, {}, 2, 5)
    got = p_lm._positions(p, {}, 2, 5, "cpu")
    assert tuple(got.shape) == (3, 2, 5)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_forward_matches_reference():
    j, p, jp, pp = _model()
    jb, pb = _batches(2, 13, seed=4)
    want, jc, _ = j_lm.forward(jp, j, jb, dtype=jnp.float32, remat=False,
                               want_cache=True)
    got, pc, _ = p_lm.forward(pp, p, pb, dtype=torch.float32,
                              want_cache=True)
    _close(got, want)
    for k in ("k", "v"):
        _close(pc["attn"][k], jc["attn"][k])
    # the patches reach the logits: other patches, other logits
    moved, _, _ = p_lm.forward(pp, p, dict(pb, vision_embeds=pb[
        "vision_embeds"] + 1.0), dtype=torch.float32)
    assert not torch.allclose(moved[:, -1], got[:, -1])


def test_mrope_decode_matches_reference():
    """Teacher-forced M-RoPE decode steps on zero caches (the
    reference's ``test_decode_matches_forward`` sequence), each step's
    logits against the reference's, both attention paths."""
    j, p, jp, pp = _model()
    jb, pb = _batches(1, 8, seed=3)
    for impl in ("dense", "registry"):
        jc_ = dataclasses.replace(j, decode_attention_impl=impl)
        pc_ = dataclasses.replace(p, decode_attention_impl=impl)
        jcache = j_lm.init_caches(jc_, 1, max_len=16, dtype=jnp.float32)
        pcache = p_lm.init_caches(pc_, 1, 16, torch.float32, "cpu")
        for t in range(8):
            jl, jcache = j_lm.decode_step(jp, jc_, jb["tokens"][:, t:t + 1],
                                          jcache, jnp.int32(t),
                                          dtype=jnp.float32)
            pl, pcache = p_lm.decode_step(pp, pc_, pb["tokens"][:, t:t + 1],
                                          pcache, t, dtype=torch.float32)
            _close(pl, jl)
        for k in ("k", "v"):
            _close(pcache["attn"][k], jcache["attn"][k])


_ENGINES = {}


def _engines(engine, impl, prompt_len=ENGINE_KW["prompt_len"]):
    key = (engine, impl, prompt_len)
    if key not in _ENGINES:
        j, p, _, _ = _model()
        kw = dict(ENGINE_KW, prompt_len=prompt_len)
        je = JEngine(j, dtype=jnp.float32, engine=engine,
                     attention_impl=impl, **kw)
        params = params_from_numpy(jax.tree.map(np.asarray, je.params), p,
                                   device="cpu")
        pe = PEngine(p, dtype=torch.float32, engine=engine,
                     attention_impl=impl, params=params, device="cpu", **kw)
        _ENGINES[key] = (je, pe)
    return _ENGINES[key]


@pytest.mark.parametrize("engine,impl", ENGINES, ids=ENGINE_IDS)
def test_engine_matches_reference_step_by_step(engine, impl):
    """DecodeEngine's M-RoPE prefill over patches and text, then each
    decode step's logits and the caches after them."""
    je, pe = _engines(engine, impl)
    jb, pb = je.make_prompt_batch(seed=1), pe.make_prompt_batch(seed=1)
    jl, jc = je.prefill(jb)
    pl, pc = pe.prefill(pb)
    _close(pl, jl)
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for i in range(je.prompt_len, je.max_len - 1):
        jl, jc = je.decode_step(jnp.asarray(tok), jc, i)
        pl, pc = pe.decode_step(torch.from_numpy(tok), pc, i)
        _close(pl, jl)
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1))[:, None]
    for k in ("k", "v"):
        _close(pc["attn"][k], jc["attn"][k])


@pytest.mark.parametrize("engine,impl", ENGINES, ids=ENGINE_IDS)
def test_engine_greedy_tokens_match_reference(engine, impl):
    je, pe = _engines(engine, impl)
    jr = je.generate(je.make_prompt_batch(seed=2))
    pr = pe.generate(pe.make_prompt_batch(seed=2))
    assert np.array_equal(pr.tokens.numpy(), np.asarray(jr.tokens))
    _close(pr.logits, jr.logits)


def test_prompt_shorter_than_the_patches_grows_as_the_reference():
    """A prompt of 6 tokens under 8 patch positions: both packages embed
    the 8 patches in its place (the sequence grows to ``frontend_len``),
    and decode from position 6 over the 8-row prefill cache, so the
    greedy tokens and logits agree.  A limit the port shares with the
    reference."""
    je, pe = _engines("vector", "registry", prompt_len=6)
    pb = pe.make_prompt_batch(seed=5)
    assert tuple(pb["tokens"].shape) == (2, 6)
    _, grown = p_lm.prefill(pe.params, pe.cfg, pb, dtype=torch.float32)
    assert tuple(grown["attn"]["k"].shape)[2] == pe.cfg.frontend_len == 8
    jl, jc = je.prefill(je.make_prompt_batch(seed=5))
    pl, pc = pe.prefill(pb)
    assert jc["attn"]["k"].shape == tuple(pc["attn"]["k"].shape)
    _close(pl, jl)
    jr = je.generate(je.make_prompt_batch(seed=5))
    pr = pe.generate(pe.make_prompt_batch(seed=5))
    assert np.array_equal(pr.tokens.numpy(), np.asarray(jr.tokens))
    _close(pr.logits, jr.logits)


def test_cast_params_casts_the_frontend():
    _, p, _, _ = _model()
    params = p_lm.init_params(p, seed=0, device="cpu")
    assert tuple(params.frontend.proj.shape) == (p.frontend_dim, p.d_model)
    cast = p_lm.cast_params(params, torch.bfloat16)
    assert cast.frontend.proj.dtype == cast.frontend.bias.dtype == \
        torch.bfloat16
    assert cast.layers[0].attn.bq.dtype == torch.bfloat16
    assert cast.final_norm.dtype == torch.float32
    eng = PEngine(p, dtype=torch.bfloat16, device="cpu", **ENGINE_KW)
    out = eng.generate(eng.make_prompt_batch(seed=8))
    assert torch.isfinite(out.logits.float()).all()


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", NAME, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "10", "--gen", "3", "--rate", "8",
                       "--duration", "0.5"])
    out = capsys.readouterr().out
    assert "served" in out and "goodput" in out and "p99" in out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["vector", "matrix"])
def test_card_mrope_decode_launches_flash_decode_per_layer(card, engine):
    """On the card, reduced Qwen2-VL (G 1 at reduced size: 4 query over 4
    KV heads) launches the engine's flash-decode kernel once per layer
    and step, the other engine's never, and its greedy tokens are the
    dense-attention path's."""
    from repro_torch.kernels import _ext
    _, p, _, _ = _model()
    other = "matrix" if engine == "vector" else "vector"
    eng = PEngine(p, dtype=torch.float32, engine=engine, device=card,
                  **ENGINE_KW)
    batch = eng.make_prompt_batch(seed=9)
    eng.warmup(batch)
    _ext.reset_launches()
    got = eng.generate(batch)
    assert _ext.LAUNCHES.get(f"attention_{engine}", 0) == \
        p.n_layers * (eng.max_gen - 1)
    assert _ext.LAUNCHES.get(f"attention_{other}", 0) == 0
    ref = PEngine(p, dtype=torch.float32, engine=engine,
                  attention_impl="dense", params=eng.params, device=card,
                  **ENGINE_KW)
    want = ref.generate(batch)
    assert torch.equal(got.tokens, want.tokens)
    torch.testing.assert_close(got.logits, want.logits, atol=ATOL, rtol=RTOL)
