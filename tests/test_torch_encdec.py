"""The encoder-decoder family (SeamlessM4T-large-v2): the port against the
reference.

The encoder (the audio frontend stub, then its unmasked layer stack and
``enc_norm``), cross-attention and its K / V caches, the forward pass,
the reference's own prefill-then-teacher-forced decode sequence
(``tests/test_arch_smoke.py::test_encdec_decode``) and ``DecodeEngine``
on both flash-decode engines and both ``attention_impl``s.  The
reference runs as its own tests run it (``jax_platform_name=cpu``,
Pallas flash-decode in interpret mode) at float32; the port runs on the
CPU with the kernels' plain versions.  Every comparison runs on the
reference's own weights, carried by ``carry.params_from_numpy`` bit for
bit, at ``reduced()`` size.

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
from repro.models import attention as j_attn  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.lm import LMDecodeExecutor as JExecutor  # noqa: E402
from repro.serving.requests import Request as JRequest  # noqa: E402

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.carry import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.data.synthetic import make_batch as p_make_batch  # noqa: E402
from repro_torch.models import attention as p_attn  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.models.engine import DecodeEngine as PEngine  # noqa: E402
from repro_torch.serving.lm import LMDecodeExecutor as PExecutor  # noqa: E402
from repro_torch.serving.requests import Request as PRequest  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

NAME = "seamless-m4t-large-v2"
ATOL, RTOL = 1e-4, 1e-3
ENGINE_KW = dict(max_batch=2, prompt_len=6, max_gen=4, seed=0)
ENGINES = [(e, impl) for e in ("vector", "matrix")
           for impl in ("registry", "dense")]
ENGINE_IDS = [f"{e}-{impl}" for e, impl in ENGINES]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _cfgs():
    return (j_configs.reduced(j_configs.get_arch(NAME)),
            p_configs.reduced(p_configs.get_arch(NAME)))


_MODEL = {}


def _model():
    """The reference's reduced weights and the port's carried copy."""
    if not _MODEL:
        j, p = _cfgs()
        params = j_lm.init_params(j, jax.random.key(0))
        _MODEL.update(j=j, p=p, jp=params, pp=params_from_numpy(
            jax.tree.map(np.asarray, params), p, device="cpu"))
    return _MODEL["j"], _MODEL["p"], _MODEL["jp"], _MODEL["pp"]


def _batches(b, s, seed):
    j, p, _, _ = _model()
    return (j_make_batch(j, b, s, seed=seed),
            p_make_batch(p, b, s, seed=seed, device="cpu"))


# --------------------------------------------------------------------------
# data and weights
# --------------------------------------------------------------------------

def test_make_batch_enc_frames_bit_for_bit():
    """``enc_frames`` (B, seq, frontend_dim) float32, drawn after the
    tokens from the same generator: every leaf equals the reference's."""
    jb, pb = _batches(3, 7, seed=11)
    assert sorted(pb) == sorted(jb)
    assert tuple(pb["enc_frames"].shape) == (3, 7, _model()[1].frontend_dim)
    assert pb["enc_frames"].dtype == torch.float32
    for k in jb:
        assert np.array_equal(pb[k].numpy(), np.asarray(jb[k])), k


def test_params_carry_the_encoder_cross_and_frontend():
    """The encoder stack, every decoder layer's ``ln_cross`` / ``cross``,
    ``enc_norm`` and the frontend cross both ways bit for bit."""
    j, p, jp, pp = _model()
    assert len(pp.encoder) == p.n_enc_layers and len(pp.layers) == p.n_layers
    assert all(layer.cross is not None for layer in pp.layers)
    assert all(layer.cross is None and layer.moe is None
               for layer in pp.encoder)
    assert np.array_equal(pp.layers[1].cross.wq.numpy(),
                          np.asarray(jp["layers"]["cross"]["wq"][1]))
    assert np.array_equal(pp.encoder[1].mlp.w_up.numpy(),
                          np.asarray(jp["encoder"]["mlp"]["w_up"][1]))
    tree = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(pp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_init_params_draws_the_reference_layout():
    """The port's own seeded weights have the reference's names, shapes and
    dtypes; the same seed gives the same weights."""
    j, p, jp, _ = _model()
    a = p_lm.init_params(p, seed=1, device="cpu")
    b = p_lm.init_params(p, seed=1, device="cpu")
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    tree = params_to_numpy(a)
    want = jax.tree.map(lambda x: (x.shape, str(x.dtype)), jp)
    got = jax.tree.map(lambda x: (x.shape, str(x.dtype)), tree)
    assert got == want
    assert not a.frontend.bias.any() and torch.equal(
        a.enc_norm, torch.ones(p.d_model))


def test_cast_params_keeps_cross_and_encoder_norms_float32():
    _, p, _, _ = _model()
    params = p_lm.init_params(p, seed=0, device="cpu")
    cast = p_lm.cast_params(params, torch.bfloat16)
    f32 = ("ln1", "ln2", "ln_cross", "final_norm", "enc_norm")
    seen = set()
    for k, v in cast.state_dict().items():
        leaf = k.split(".")[-1]
        assert v.dtype == (torch.float32 if leaf in f32 else
                           torch.bfloat16), k
        seen.add(k.split(".")[0] + "." + leaf)
    assert {"layers.ln_cross", "enc_norm.enc_norm", "frontend.proj",
            "frontend.bias"} <= seen
    assert cast.layers[0].cross.wq.dtype == torch.bfloat16
    assert sorted(cast.state_dict()) == sorted(params.state_dict())


# --------------------------------------------------------------------------
# cross-attention and the encoder
# --------------------------------------------------------------------------

def _draw(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_make_cross_kv_and_cross_attend_match_reference():
    """One decoder layer's cross-attention: K / V projected from an
    encoder output, then a query stream attending to all of it."""
    j, p, jp, pp = _model()
    jcross = jax.tree.map(lambda a: a[1], jp["layers"]["cross"])
    pcross = pp.layers[1].cross
    enc, x = _draw(2, 9, p.d_model, seed=1), _draw(2, 5, p.d_model, seed=2)
    jk, jv = j_attn.make_cross_kv(jcross, jnp.asarray(enc), j)
    pk, pv = p_attn.make_cross_kv(pcross, torch.from_numpy(enc), p)
    assert tuple(pk.shape) == (2, 9, p.n_kv_heads, p.head_dim)
    _close(pk, jk)
    _close(pv, jv)
    qpos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    kpos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    want = j_attn.cross_attend(jcross, jnp.asarray(x), j, (jk, jv),
                               jnp.asarray(qpos), jnp.asarray(kpos))
    got = p_attn.cross_attend(pcross, torch.from_numpy(x), p, (pk, pv),
                              torch.from_numpy(qpos.copy()),
                              torch.from_numpy(kpos.copy()))
    _close(got, want)
    # attention(kv_x=...) is both, returning the encoder's K / V
    pos = torch.from_numpy(qpos.copy())
    out, ckv = p_attn.attention(pcross, torch.from_numpy(x), p,
                                positions=pos, kv_x=torch.from_numpy(enc),
                                kv_positions=torch.from_numpy(kpos.copy()))
    assert sorted(ckv) == ["ck", "cv"]
    torch.testing.assert_close(out, got, rtol=0, atol=0)
    torch.testing.assert_close(ckv["ck"], pk, rtol=0, atol=0)


def test_encode_matches_reference():
    """The frontend stub, the encoder stack at causal=False and
    ``enc_norm``: the encoder's output and positions."""
    j, p, jp, pp = _model()
    jb, pb = _batches(2, 7, seed=3)
    jout, jpos = j_lm._encode(jp, j, jb, jnp.float32)
    pout, ppos = p_lm._encode(pp, p, pb, torch.float32)
    _close(pout, jout)
    assert np.array_equal(ppos.numpy(), np.asarray(jpos))
    # unmasked: the last frame changes the first position's output
    frames = pb["enc_frames"].clone()
    frames[:, -1] += 1.0
    moved, _ = p_lm._encode(pp, p, dict(pb, enc_frames=frames), torch.float32)
    assert not torch.allclose(moved[:, 0], pout[:, 0])


def test_forward_matches_reference():
    j, p, jp, pp = _model()
    jb, pb = _batches(2, 9, seed=4)
    want, jc, _ = j_lm.forward(jp, j, jb, dtype=jnp.float32, remat=False,
                               want_cache=True)
    got, pc, aux = p_lm.forward(pp, p, pb, dtype=torch.float32,
                                want_cache=True)
    _close(got, want)
    assert sorted(pc["attn"]) == sorted(jc["attn"]) == ["ck", "cv", "k", "v"]
    for k in ("k", "v", "ck", "cv"):
        _close(pc["attn"][k], jc["attn"][k])
    assert float(aux["aux_loss"]) == 0.0


def test_init_and_pad_caches_match_reference():
    """``enc_len`` sizes ``ck`` / ``cv`` (default max_len); pad_caches grows
    the self-attention's caches only."""
    j, p, _, _ = _model()
    for enc_len in (None, 5):
        jc = j_lm.init_caches(j, 2, 8, jnp.float32, enc_len=enc_len)
        pc = p_lm.init_caches(p, 2, 8, torch.float32, "cpu", enc_len=enc_len)
        assert sorted(pc) == sorted(jc)
        for k in ("k", "v", "ck", "cv"):
            assert tuple(pc["attn"][k].shape) == jc["attn"][k].shape, k
            assert not pc["attn"][k].any()
    short = {"attn": {k: np.ones((p.n_layers, 2, 5, 4, 32), np.float32)
                      for k in ("k", "v", "ck", "cv")}}
    want = j_lm.pad_caches(jax.tree.map(jnp.asarray, short), 9)["attn"]
    got = p_lm.pad_caches({"attn": {k: torch.from_numpy(v) for k, v in
                                    short["attn"].items()}}, 9)["attn"]
    for k in ("k", "v", "ck", "cv"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert tuple(got["ck"].shape) == (p.n_layers, 2, 5, 4, 32)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine,impl", ENGINES, ids=ENGINE_IDS)
def test_encdec_decode_sequence_matches_reference(engine, impl):
    """The reference's ``test_encdec_decode`` sequence: a prefill of one
    token (the encoder over all 8 frames fills the cross K / V), then
    teacher-forced steps, each step's logits held against the
    reference's; the cross K / V are never written by a step."""
    j, p, jp, pp = _model()
    j = dataclasses.replace(j, decode_attention_impl=impl,
                            decode_attention_engine=engine)
    p = dataclasses.replace(p, decode_attention_impl=impl,
                            decode_attention_engine=engine)
    jb, pb = _batches(1, 8, seed=4)
    jl, jc = j_lm.prefill(jp, j, dict(jb, tokens=jb["tokens"][:, :1]),
                          dtype=jnp.float32)
    pl, pc = p_lm.prefill(pp, p, dict(pb, tokens=pb["tokens"][:, :1]),
                          dtype=torch.float32)
    _close(pl, jl)
    jc, pc = j_lm.pad_caches(jc, max_len=16), p_lm.pad_caches(pc, 16)
    assert tuple(pc["attn"]["ck"].shape) == jc["attn"]["ck"].shape
    cross = {k: pc["attn"][k].clone() for k in ("ck", "cv")}
    for t in range(1, 8):
        jl, jc = j_lm.decode_step(jp, j, jb["tokens"][:, t:t + 1], jc,
                                  jnp.int32(t), dtype=jnp.float32)
        pl, pc = p_lm.decode_step(pp, p, pb["tokens"][:, t:t + 1], pc, t,
                                  dtype=torch.float32)
        _close(pl, jl)
    for k in ("k", "v", "ck", "cv"):
        _close(pc["attn"][k], jc["attn"][k])
        if k in cross:
            assert torch.equal(pc["attn"][k], cross[k])


_ENGINES = {}


def _engines(engine, impl):
    key = (engine, impl)
    if key not in _ENGINES:
        j, p, _, _ = _model()
        je = JEngine(j, dtype=jnp.float32, engine=engine,
                     attention_impl=impl, **ENGINE_KW)
        params = params_from_numpy(jax.tree.map(np.asarray, je.params), p,
                                   device="cpu")
        pe = PEngine(p, dtype=torch.float32, engine=engine,
                     attention_impl=impl, params=params, device="cpu",
                     **ENGINE_KW)
        _ENGINES[key] = (je, pe)
    return _ENGINES[key]


@pytest.mark.parametrize("engine,impl", ENGINES, ids=ENGINE_IDS)
def test_engine_matches_reference_step_by_step(engine, impl):
    """DecodeEngine: the prefill's last logits and caches (``ck`` / ``cv``
    at the prompt's length, unpadded), then each decode step's logits."""
    je, pe = _engines(engine, impl)
    jb, pb = je.make_prompt_batch(seed=1), pe.make_prompt_batch(seed=1)
    assert np.array_equal(np.asarray(jb["enc_frames"]),
                          pb["enc_frames"].numpy())
    jl, jc = je.prefill(jb)
    pl, pc = pe.prefill(pb)
    _close(pl, jl)
    assert tuple(pc["attn"]["k"].shape)[2] == pe.max_len
    assert tuple(pc["attn"]["ck"].shape)[2] == pe.prompt_len
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for i in range(je.prompt_len, je.max_len - 1):
        jl, jc = je.decode_step(jnp.asarray(tok), jc, i)
        pl, pc = pe.decode_step(torch.from_numpy(tok), pc, i)
        _close(pl, jl)
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1))[:, None]
    for k in ("k", "v", "ck", "cv"):
        _close(pc["attn"][k], jc["attn"][k])


@pytest.mark.parametrize("engine,impl", ENGINES, ids=ENGINE_IDS)
def test_engine_greedy_tokens_match_reference(engine, impl):
    je, pe = _engines(engine, impl)
    jr = je.generate(je.make_prompt_batch(seed=2))
    pr = pe.generate(pe.make_prompt_batch(seed=2))
    assert np.array_equal(pr.tokens.numpy(), np.asarray(jr.tokens))
    _close(pr.logits, jr.logits)
    assert pr.decode_steps == jr.decode_steps == je.max_gen - 1


def test_decode_launches_flash_decode_per_decoder_layer(monkeypatch):
    """Only the decoder's self-attention runs flash-decode: one launch
    per decoder layer and step; cross-attention and the encoder none."""
    from repro_torch.kernels.attention import ops
    calls = []
    original = ops.ATTENTION_OP.engines["vector"]

    def spy(*args, **kwargs):
        calls.append(tuple(args[1].shape))
        return original(*args, **kwargs)
    monkeypatch.setitem(ops.ATTENTION_OP.engines, "vector", spy)
    _, pe = _engines("vector", "registry")
    assert pe.flash_decode_layers == pe.cfg.n_layers
    pe.generate(pe.make_prompt_batch(seed=6))
    cfg = pe.cfg
    assert calls == [(2, pe.max_len, cfg.n_kv_heads, cfg.head_dim)] * (
        (pe.max_gen - 1) * cfg.n_layers)


def test_cache_state_round_trips_cross_kv():
    """``cache_state`` snapshots ``ck`` / ``cv`` with the self-attention's
    caches, and ``load_cache_state`` checks and copies them; a decode step
    after the snapshot leaves it as it was."""
    _, pe = _engines("vector", "registry")
    logits, caches = pe.prefill(pe.make_prompt_batch(seed=7))
    state = pe.cache_state(caches)
    back = pe.load_cache_state(caches, state)
    for k in ("k", "v", "ck", "cv"):
        assert torch.equal(back["attn"][k], caches["attn"][k])
        assert back["attn"][k].data_ptr() != state["attn"][k].data_ptr()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    pe.decode_step(tok, caches, pe.prompt_len)
    assert not torch.equal(caches["attn"]["k"], state["attn"]["k"])
    assert torch.equal(caches["attn"]["ck"], state["attn"]["ck"])
    bad = dict(state["attn"], ck=state["attn"]["ck"][:, :, :1])
    with pytest.raises(ValueError, match="mismatch"):
        pe.load_cache_state(caches, {"attn": bad})


def test_bfloat16_engine_runs_on_cast_weights():
    _, p, _, _ = _model()
    eng = PEngine(p, dtype=torch.bfloat16, device="cpu", **ENGINE_KW)
    assert eng.params.layers[0].cross.wk.dtype == torch.bfloat16
    assert eng.params.layers[0].ln_cross.dtype == torch.float32
    out = eng.generate(eng.make_prompt_batch(seed=8))
    assert out.caches["attn"]["ck"].dtype == torch.bfloat16
    assert torch.isfinite(out.logits.float()).all()


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_executor_matches_reference():
    j, p, _, _ = _model()
    jfull = j_configs.get_arch(NAME)
    pfull = p_configs.get_arch(NAME)
    je = JExecutor(j, dtype=jnp.float32, engine="vector", verdict_cfg=jfull,
                   **ENGINE_KW)
    pe = PExecutor(p, dtype=torch.float32, engine="vector",
                   verdict_cfg=pfull, device="cpu", **ENGINE_KW)
    jreqs = [JRequest(rid=i, kernel="lm-decode", arrival_s=0.0, size=4)
             for i in range(2)]
    preqs = [PRequest(rid=i, kernel="lm-decode", arrival_s=0.0, size=4)
             for i in range(2)]
    jx, px = je.execute(jreqs), pe.execute(preqs)
    assert px.engine == jx.engine
    jr, pr = je.record_extras(), pe.record_extras()
    assert pr["model"] == jr["model"] == NAME
    assert pr["phases"]["decode_steps"] == jr["phases"]["decode_steps"]
    names = [o["name"] for o in pr["verdict"]["ops"]]
    assert names == [o["name"] for o in jr["verdict"]["ops"]]
    assert "cross_attn" in names


def test_launch_serve_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", NAME, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "6", "--gen", "3", "--rate", "8",
                       "--duration", "0.5"])
    out = capsys.readouterr().out
    assert "served" in out and "goodput" in out and "p99" in out


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
def test_card_decoder_launches_flash_decode_per_layer(card, engine):
    """On the card, reduced SeamlessM4T launches the engine's
    flash-decode kernel once per decoder layer and step (cross-attention
    and the encoder none), the other engine's never, and its greedy
    tokens are the dense-attention path's."""
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
