"""The LM decode slice: configs, verdict, layers, MoE, MLA, the SSM and
hybrid families, weights, engine, executor (the encoder-decoder and
vision families in depth: ``test_torch_encdec.py``,
``test_torch_vision.py``).

The reference runs as its own tests run it (``jax_platform_name=cpu``,
Pallas flash-decode in interpret mode); the port runs on the CPU with
the kernels' plain versions.  Inputs are numpy draws from a seed, and the
JAX model's weights are carried into the port bit for bit.

Tolerances: rmsnorm 1e-6, RoPE and SwiGLU 1e-5 (float32 summation order,
and cos/sin/pow that differ in the last bit between libraries); the
engine's prefill and per-step logits atol 1e-4 and rtol 1e-3, the
reference's own tier (``tests/test_model_engine.py``); greedy tokens
exactly equal.  The MoE FFN's output atol = rtol = 1e-5 (its per-token
sum over the kept slots runs in top-k order, the reference's in expert
order), its aux and z losses 1e-6; MLA's outputs and caches 1e-5.
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
from repro.core import advisor as j_advisor  # noqa: E402
from repro.core import hw as j_hw  # noqa: E402
from repro.core.dispatch import Dispatcher as JDispatcher  # noqa: E402
from repro.models import advisor_map as j_map  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.lm import LMDecodeExecutor as JExecutor  # noqa: E402
from repro.serving.requests import Request as JRequest  # noqa: E402

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.carry import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import advisor as p_advisor  # noqa: E402
from repro_torch.core import hw as p_hw  # noqa: E402
from repro_torch.core.dispatch import Dispatcher as PDispatcher  # noqa: E402
from repro_torch.models import advisor_map as p_map  # noqa: E402
from repro_torch.models import layers as p_layers  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.models.attention import make_cache  # noqa: E402
from repro_torch.models.engine import DecodeEngine as PEngine  # noqa: E402
from repro_torch.serving.lm import LMDecodeExecutor as PExecutor  # noqa: E402
from repro_torch.serving.requests import Request as PRequest  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH_NAMES = sorted(j_configs.ARCHS)
DENSE = ("deepseek-7b", "mistral-nemo-12b", "qwen1.5-32b", "stablelm-12b")
#: The MoE family: MLA + a leading dense layer, and GQA at G = 16 in full.
MOE = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
#: The SSM family (Mamba2) and the hybrid (Zamba2: SSM super-blocks, one
#: shared attention block after each).
SSM = ("mamba2-780m", "zamba2-7b")
#: The multimodal-frontend families: the encoder-decoder (SeamlessM4T,
#: audio frames into its encoder) and the vision frontend with M-RoPE.
FRONTEND = ("seamless-m4t-large-v2", "qwen2-vl-72b")
RUNNING = DENSE + MOE + SSM + FRONTEND
ENGINE_KW = dict(max_batch=2, prompt_len=6, max_gen=4, seed=0)


def _pair(name):
    return j_configs.get_arch(name), p_configs.get_arch(name)


def _smoke_pair(n_kv_heads=None):
    """reduced(mistral-nemo-12b) (G = 1), or its GQA variant."""
    j, p = (j_configs.reduced(c) for c in _pair("mistral-nemo-12b"))
    if n_kv_heads is not None:
        j = dataclasses.replace(j, n_kv_heads=n_kv_heads)
        p = dataclasses.replace(p, n_kv_heads=n_kv_heads)
    return j, p


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# configs and the verdict
# --------------------------------------------------------------------------

def test_arch_registry_matches_reference():
    assert sorted(p_configs.ARCHS) == ARCH_NAMES


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_and_reduced_match_reference(name):
    j, p = _pair(name)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert dataclasses.asdict(p_configs.reduced(p)) == \
        dataclasses.asdict(j_configs.reduced(j))
    assert p.param_count() == j.param_count()
    assert p.active_param_count() == j.active_param_count()
    assert p.vocab_padded == j.vocab_padded


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        p_configs.get_arch("no-such-model")


def _dispatchers(platform):
    spec = p_hw.get_platform(platform)
    jspec = j_hw.HardwareSpec(
        name=spec.name, mem_bw=spec.mem_bw, l2_bytes=spec.l2_bytes,
        link_bw=spec.link_bw, chips=spec.chips,
        engines={k: j_hw.Engine(e.name, e.peak_flops, e.dtype)
                 for k, e in spec.engines.items()})
    return (JDispatcher(advisor=j_advisor.EngineAdvisor(jspec)),
            PDispatcher(advisor=p_advisor.EngineAdvisor(spec)))


@pytest.mark.parametrize("batch,cache_len", [(4, 32), (128, 32768)])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_verdict_matches_reference(name, batch, cache_len):
    j, p = _pair(name)
    jd, pd = _dispatchers("h100")
    for dtype_bytes in (2, 4):
        jt = j_map.step_traits(j, batch, cache_len, dtype_bytes=dtype_bytes)
        pt = p_map.step_traits(p, batch, cache_len, dtype_bytes=dtype_bytes)
        assert dataclasses.asdict(pt) == dataclasses.asdict(jt)
        jv = j_map.model_verdict(j, batch, cache_len,
                                 dtype_bytes=dtype_bytes, dispatcher=jd)
        pv = p_map.model_verdict(p, batch, cache_len,
                                 dtype_bytes=dtype_bytes, dispatcher=pd)
        assert dataclasses.asdict(pv) == dataclasses.asdict(jv)
        assert p_map.verdict_payload(pv, 12.5) == \
            j_map.verdict_payload(jv, 12.5)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _draw(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rmsnorm_matches_reference():
    w, x = _draw(32, seed=1), _draw(3, 5, 32, seed=2)
    want = j_layers.rmsnorm(jnp.asarray(w), jnp.asarray(x), 1e-5)
    got = p_layers.rmsnorm(torch.from_numpy(w), torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta):
    x = _draw(2, 7, 4, 32, seed=3)
    pos = np.tile(np.arange(100, 107, dtype=np.int32), (2, 1))
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = p_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_apply_mrope_matches_reference():
    x = _draw(2, 5, 4, 32, seed=4)
    pos = np.stack([np.tile(np.arange(5, dtype=np.int32) * (i + 1), (2, 1))
                    for i in range(3)])
    want = j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                                (4, 6, 6))
    got = p_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                               1e4, (4, 6, 6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mlp_matches_reference():
    wg, wu, wd = _draw(16, 48, seed=5), _draw(16, 48, seed=6), \
        _draw(48, 16, seed=7)
    x = _draw(2, 3, 16, seed=8)
    want = j_layers.mlp({"w_gate": jnp.asarray(wg), "w_up": jnp.asarray(wu),
                         "w_down": jnp.asarray(wd)}, jnp.asarray(x))
    block = p_lm.Block({"w_gate": torch.from_numpy(wg),
                        "w_up": torch.from_numpy(wu),
                        "w_down": torch.from_numpy(wd)})
    got = p_layers.mlp(block, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", RUNNING)
def test_params_round_trip_bit_for_bit(name):
    """The layer stacks (``layers``, ``first_dense``; a hybrid's
    (super-block, layer) ``layers`` and ``tail``), the unstacked
    ``shared_attn`` block and the ``moe``, ``moe/shared``, MLA and ``ssm``
    leaves cross both ways bit for bit."""
    from repro.models import lm as j_lm
    j, p = (j_configs.reduced(c) for c in _pair(name))
    tree = _np(j_lm.init_params(j, jax.random.key(3)))
    port = params_from_numpy(tree, p, device="cpu")
    if p.family == "hybrid":
        n_super, n_tail = divmod(p.n_layers, p.attn_every)
        assert [len(b) for b in port.layers] == [p.attn_every] * n_super
        assert len(port.tail) == n_tail
        assert port.layers[1][2].ssm.w_z.data_ptr() != \
            port.layers[0][2].ssm.w_z.data_ptr()
    elif p.family == "ssm":
        assert len(port.layers) == p.n_layers
    else:
        assert len(port.layers) == p.n_layers - p.first_dense_layers
        assert len(port.first_dense) == p.first_dense_layers
    back = params_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    n = sum(t.numel() for t in port.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(tree))
    # param_count leaves out MLA's kv_norm weights, the SSM's conv
    # biases and dt_bias (and an SSM model's ln1), and enc_norm
    if p.enc_dec:
        n -= p.d_model
    if not p.use_mla and p.family not in ("ssm", "hybrid"):
        assert n == p.param_count()


def test_init_params_is_seeded_and_sized():
    _, p = _smoke_pair()
    a = p_lm.init_params(p, seed=1, device="cpu")
    b = p_lm.init_params(p, seed=1, device="cpu")
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    assert sum(t.numel() for t in a.parameters()) == p.param_count()
    assert a.embed.shape == (p.vocab_padded, p.d_model)


def test_cast_params_keeps_norms_in_float32():
    _, p = _smoke_pair()
    params = p_lm.init_params(p, seed=0, device="cpu")
    cast = p_lm.cast_params(params, torch.bfloat16)
    for k, v in cast.state_dict().items():
        want = torch.float32 if k.split(".")[-1] in (
            "ln1", "ln2", "final_norm") else torch.bfloat16
        assert v.dtype == want, k
    assert p_lm.cast_params(params, torch.float32) is params


@pytest.mark.parametrize("name", SSM)
def test_cast_params_keeps_ssm_float32_leaves(name):
    """At bfloat16 the SSM's a_log, dt_bias, d_skip and norm stay float32
    (the reference applies them in float32), with every norm; the
    projections, convs and the shared block's matmuls are cast."""
    cfg = p_configs.reduced(p_configs.get_arch(name))
    params = p_lm.init_params(cfg, seed=0, device="cpu")
    cast = p_lm.cast_params(params, torch.bfloat16)
    f32 = ("ln1", "ln2", "final_norm", "a_log", "dt_bias", "d_skip", "norm")
    seen = set()
    for k, v in cast.state_dict().items():
        leaf = k.split(".")[-1]
        want = torch.float32 if leaf in f32 else torch.bfloat16
        assert v.dtype == want, k
        seen.add(leaf)
    assert {"a_log", "dt_bias", "d_skip", "norm", "w_z", "conv_x",
            "out_proj"} <= seen
    assert sorted(cast.state_dict()) == sorted(params.state_dict())


# --------------------------------------------------------------------------
# the slice as a whole: DecodeEngine, JAX against the port
# --------------------------------------------------------------------------

_ENGINES = {}


def _engines(n_kv_heads, engine, impl):
    """A JAX engine and the port's engine on its carried weights."""
    key = (n_kv_heads, engine, impl)
    if key not in _ENGINES:
        j, p = _smoke_pair(n_kv_heads)
        je = JEngine(j, dtype=jnp.float32, engine=engine,
                     attention_impl=impl, **ENGINE_KW)
        params = params_from_numpy(_np(je.params), p, device="cpu")
        pe = PEngine(p, dtype=torch.float32, engine=engine,
                     attention_impl=impl, params=params, device="cpu",
                     **ENGINE_KW)
        _ENGINES[key] = (je, pe)
    return _ENGINES[key]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)


SLICE = [(kv, e, impl) for kv in (None, 2) for e in ("vector", "matrix")
         for impl in ("registry", "dense")]
SLICE_IDS = [f"{'G2' if kv else 'G1'}-{e}-{impl}" for kv, e, impl in SLICE]


@pytest.mark.parametrize("n_kv_heads,engine,impl", SLICE, ids=SLICE_IDS)
def test_engine_matches_reference_step_by_step(n_kv_heads, engine, impl):
    """Prefill logits, then every teacher-forced decode step's logits."""
    je, pe = _engines(n_kv_heads, engine, impl)
    jb, pb = je.make_prompt_batch(seed=1), pe.make_prompt_batch(seed=1)
    assert np.array_equal(np.asarray(jb["tokens"]), pb["tokens"].numpy())
    jl, jc = je.prefill(jb)
    pl, pc = pe.prefill(pb)
    assert tuple(pl.shape) == jl.shape
    _close(pl, jl)
    for k in ("k", "v"):
        assert tuple(pc["attn"][k].shape) == jc["attn"][k].shape
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for i in range(je.prompt_len, je.max_len - 1):
        jl, jc = je.decode_step(jnp.asarray(tok), jc, i)
        pl, pc = pe.decode_step(torch.from_numpy(tok), pc, i)
        _close(pl, jl)
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1))[:, None]
    for k in ("k", "v"):
        _close(pc["attn"][k], jc["attn"][k])


@pytest.mark.parametrize("n_kv_heads,engine,impl", SLICE, ids=SLICE_IDS)
def test_engine_greedy_tokens_match_reference(n_kv_heads, engine, impl):
    je, pe = _engines(n_kv_heads, engine, impl)
    jr = je.generate(je.make_prompt_batch(seed=2))
    pr = pe.generate(pe.make_prompt_batch(seed=2))
    assert np.array_equal(pr.tokens.numpy(), np.asarray(jr.tokens))
    _close(pr.logits, jr.logits)
    assert pr.decode_steps == jr.decode_steps == je.max_gen - 1
    assert pr.per_step_s > 0


@pytest.mark.parametrize("engine", ["vector", "matrix"])
def test_warmup_keeps_the_greedy_tokens(engine):
    """``DecodeEngine.warmup`` (the reference's method) leaves the
    engine as it was: the same greedy tokens after it as without it, and
    the reference's after its own warmup."""
    je, pe = _engines(2, engine, "registry")
    batch = pe.make_prompt_batch(seed=3)
    before = pe.generate(batch).tokens
    pe.warmup()
    pe.warmup(batch)
    after = pe.generate(batch).tokens
    assert torch.equal(after, before)
    je.warmup()
    jr = je.generate(je.make_prompt_batch(seed=3))
    assert np.array_equal(after.numpy(), np.asarray(jr.tokens))


def test_forward_matches_reference():
    from repro.models import lm as j_lm
    je, pe = _engines(2, "vector", "registry")
    tokens = np.random.default_rng(4).integers(0, 512, (2, 9), np.int32)
    want, _, _ = j_lm.forward(je.params, je.cfg,
                              {"tokens": jnp.asarray(tokens)},
                              dtype=jnp.float32, remat=False)
    got, caches, aux = p_lm.forward(pe.params, pe.cfg,
                                    {"tokens": torch.from_numpy(tokens)},
                                    dtype=torch.float32)
    _close(got, want)
    assert caches is None and float(aux["aux_loss"]) == 0.0


def test_chunked_prefill_matches_dense_path():
    """sdpa's chunked online-softmax loop (long prompts) == dense."""
    from repro_torch.models.attention import _sdpa_dense, _sdpa_flash
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 8, 2, 2, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 8, 2, 16)).astype(
        np.float32))
    pos = torch.arange(8)[None].expand(2, 8)
    want = _sdpa_dense(q, k, v, pos, pos, causal=True)
    got = _sdpa_flash(q, k, v, pos, pos, True, 4, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_decode_attention_goes_through_the_registry_op(monkeypatch):
    from repro_torch.kernels.attention import ops
    calls = []
    original = ops.ATTENTION_OP.engines["vector"]

    def spy(*args, **kwargs):
        calls.append(kwargs["backend"])
        return original(*args, **kwargs)
    monkeypatch.setitem(ops.ATTENTION_OP.engines, "vector", spy)
    _, pe = _engines(2, "vector", "registry")
    pe.generate(pe.make_prompt_batch(seed=6))
    steps = pe.max_gen - 1
    assert calls == ["plain"] * (steps * pe.cfg.n_layers)


def test_cache_state_round_trip():
    _, pe = _engines(None, "vector", "registry")
    _, caches = pe.prefill(pe.make_prompt_batch(seed=7))
    state = pe.cache_state(caches)
    back = pe.load_cache_state(caches, state)
    assert torch.equal(back["attn"]["k"], caches["attn"]["k"])
    bad = {"attn": {"k": caches["attn"]["k"][:, :1], "v": caches["attn"]["v"]}}
    with pytest.raises(ValueError, match="mismatch"):
        pe.load_cache_state(caches, bad)


def test_cache_state_is_a_snapshot_matching_reference():
    """A state taken after prefill stays that of prefill through a decode
    step (which writes the caches in place), equal to a clone taken before
    the step and to the reference's state at the same point; a loaded
    state is a copy the next step does not write through."""
    je, pe = _engines(None, "vector", "registry")
    jb, pb = je.make_prompt_batch(seed=8), pe.make_prompt_batch(seed=8)
    jlogits, jcaches = je.prefill(jb)
    plogits, pcaches = pe.prefill(pb)
    jstate = je.cache_state(jcaches)
    pstate = pe.cache_state(pcaches)
    before = {k: t.clone() for k, t in pcaches["attn"].items()}
    loaded = pe.load_cache_state(pcaches, pstate)
    jtok = jnp.argmax(jlogits[:, -1], axis=-1)[:, None]
    ptok = torch.argmax(plogits[:, -1], dim=-1)[:, None]
    je.decode_step(jtok, jcaches, je.prompt_len)
    pe.decode_step(ptok, pcaches, pe.prompt_len)
    pe.decode_step(ptok, loaded, pe.prompt_len)
    for k in ("k", "v"):
        assert not torch.equal(pcaches["attn"][k], before[k])  # written
        assert torch.equal(pstate["attn"][k], before[k])
        assert pstate["attn"][k].data_ptr() != pcaches["attn"][k].data_ptr()
        _close(pstate["attn"][k], jstate["attn"][k])
    assert not torch.equal(loaded["attn"]["k"], pstate["attn"]["k"])


def test_init_and_pad_caches_match_reference():
    from repro.models import lm as j_lm
    j, p = _smoke_pair(2)
    jc = j_lm.init_caches(j, 2, 8, jnp.float32)
    pc = p_lm.init_caches(p, 2, 8, torch.float32, "cpu")
    for k in ("k", "v"):
        assert tuple(pc["attn"][k].shape) == jc["attn"][k].shape
        assert not pc["attn"][k].any()
    short = {"attn": {k: torch.ones((p.n_layers, 2, 5, 2, 32))
                      for k in ("k", "v")}}
    padded = p_lm.pad_caches(short, 8)["attn"]["k"]
    want = j_lm.pad_caches({"attn": {k: jnp.ones((p.n_layers, 2, 5, 2, 32))
                                     for k in ("k", "v")}}, 8)["attn"]["k"]
    assert np.array_equal(padded.numpy(), np.asarray(want))


def test_bfloat16_engine_runs_on_cast_weights():
    _, p = _smoke_pair(2)
    eng = PEngine(p, dtype=torch.bfloat16, device="cpu", **ENGINE_KW)
    assert eng.params.layers[0].attn.wq.dtype == torch.bfloat16
    assert eng.params.layers[0].ln1.dtype == torch.float32
    out = eng.generate(eng.make_prompt_batch(seed=8))
    assert out.logits.dtype == torch.bfloat16
    assert out.caches["attn"]["k"].dtype == torch.bfloat16
    assert torch.isfinite(out.logits.float()).all()
    assert eng.dtype_bytes == 2 and eng.traits().traffic_bytes > 0


# --------------------------------------------------------------------------
# the executor
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["auto", "vector", "matrix"])
def test_executor_matches_reference(engine):
    j, p = _smoke_pair(2)
    jfull, pfull = _pair("mistral-nemo-12b")
    je = JExecutor(j, max_batch=2, prompt_len=6, max_gen=4,
                   dtype=jnp.float32, engine=engine, verdict_cfg=jfull)
    pe = PExecutor(p, max_batch=2, prompt_len=6, max_gen=4,
                   dtype=torch.float32, engine=engine, verdict_cfg=pfull,
                   device="cpu")
    jreqs = [JRequest(rid=i, kernel="lm-decode", arrival_s=0.0, size=4)
             for i in range(2)]
    preqs = [PRequest(rid=i, kernel="lm-decode", arrival_s=0.0, size=4)
             for i in range(2)]
    for _ in range(2):
        jx, px = je.execute(jreqs), pe.execute(preqs[:1])
        assert px.engine == jx.engine and px.shards == jx.shards
        assert px.compute_s > 0
    jr, pr = je.record_extras(), pe.record_extras()
    assert pr.keys() == jr.keys() and pr["model"] == jr["model"]
    assert pr["phases"].keys() == jr["phases"].keys()
    assert pr["phases"]["decode_steps"] == jr["phases"]["decode_steps"]
    assert pr["phases"]["launches"] == jr["phases"]["launches"]

    def static(payload):
        drop = ("step_time_ms", "time_ms")
        out = {k: v for k, v in payload.items() if k not in drop}
        out["ops"] = [{k: v for k, v in o.items() if k not in drop}
                      for o in payload["ops"]]
        return out
    assert static(pr["verdict"]) == static(jr["verdict"])
    # the default advisors model other cards (H100 here, v5e there): the
    # decode step is memory-bound on both
    pa = pe.advice_for("lm-decode", 4, "float32")
    ja = je.advice_for("lm-decode", 4, "float32")
    assert (pa.engine, pa.memory_bound, pa.intensity) == \
        (ja.engine, ja.memory_bound, ja.intensity)


# --------------------------------------------------------------------------
# every config runs; what waits, and no card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_config_builds_an_engine(name):
    """check_family refuses no config in configs/ (at full size), and each
    builds an engine whose prompt batch carries the reference's inputs:
    tokens, and a family's patch embeddings or audio frames, bit for bit
    (``test_dense_families_run`` generates with each)."""
    from repro.data.synthetic import make_batch as j_make_batch
    p_lm.check_family(p_configs.get_arch(name))
    j, p = (j_configs.reduced(c) for c in _pair(name))
    eng = PEngine(p, device="cpu", **ENGINE_KW)
    got = eng.make_prompt_batch(seed=3)
    want = j_make_batch(j, ENGINE_KW["max_batch"], ENGINE_KW["prompt_len"],
                        seed=3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_unknown_frontend_raises():
    cfg = dataclasses.replace(_smoke_pair()[1], frontend="video")
    with pytest.raises(ValueError, match="frontend"):
        p_lm.check_family(cfg)


@pytest.mark.parametrize("name", RUNNING)
def test_dense_families_run(name):
    """Every ported family generates on its own seeded weights (the SSM
    and hybrid families' cases moved here from
    ``test_waiting_families_raise``)."""
    cfg = p_configs.reduced(p_configs.get_arch(name))
    p_lm.check_family(cfg)
    eng = PEngine(cfg, device="cpu", **ENGINE_KW)
    out = eng.generate(eng.make_prompt_batch())
    assert tuple(out.tokens.shape) == (2, 4)
    assert torch.isfinite(out.logits).all()


def test_training_and_int8_cache_wait():
    """Nothing waits any more: ``loss_fn`` and the int8 cache run (their
    parity with the reference: ``test_torch_train.py`` and
    ``test_torch_int8_cache.py``)."""
    _, p = _smoke_pair()
    assert p_lm.WAITING == {}
    params = p_lm.init_params(p, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.ones((1, 4), dtype=torch.int32)}
    loss, metrics = p_lm.loss_fn(params, p, batch, dtype=torch.float32)
    assert bool(torch.isfinite(loss)) and set(metrics) == {
        "loss", "nll", "aux_loss", "z_loss"}
    cache = make_cache(p, 1, 8, torch.int8, "cpu")
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].shape == (1, 8, p.n_kv_heads)


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, p = _smoke_pair()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PEngine(p, **ENGINE_KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PExecutor(p)


# --------------------------------------------------------------------------
# MoE layers and MLA attention against the reference
# --------------------------------------------------------------------------

def _block(tree):
    """A reference parameter dict (numpy leaves) as the port's Block."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = torch.from_numpy(np.asarray(v).copy())
    walk(tree, "")
    return p_lm.Block(flat)


def _moe_pair(name, **changes):
    j, p = (dataclasses.replace(j_configs.reduced(c), **changes)
            for c in _pair(name))
    return j, p


#: (arch, config changes, tokens (B, S), group size): the reduced Qwen3
#: (no shared experts) and DeepSeek (two shared); a capacity factor that
#: drops tokens; 24 tokens in groups of 16, which fall back to 3 groups of 8
MOE_CASES = [("qwen3-moe-235b-a22b", {}, (2, 16), 2048),
             ("deepseek-v2-lite-16b", {}, (2, 16), 2048),
             ("qwen3-moe-235b-a22b", {"capacity_factor": 0.25}, (2, 32),
              2048),
             ("deepseek-v2-lite-16b", {}, (3, 8), 16)]


@pytest.mark.parametrize("name,changes,shape,group", MOE_CASES,
                         ids=["qwen3", "deepseek-shared", "drops",
                              "group-fallback"])
def test_moe_ffn_matches_reference(name, changes, shape, group):
    from repro.models import moe as j_moe
    from repro_torch.models import moe as p_moe
    j, p = _moe_pair(name, **changes)
    params = _np(j_moe.init_moe(jax.random.key(5), j))
    x = _draw(*shape, p.d_model, seed=6)
    want, jaux = j_moe.moe_ffn(params, jnp.asarray(x), j, group_size=group)
    got, paux = p_moe.moe_ffn(_block(params), torch.from_numpy(x), p,
                              group_size=group)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(paux[k]), float(jaux[k]),
                                   rtol=1e-6, atol=1e-6)
    # the routing the case asks for: some expert overflows where the
    # capacity is cut; 3 groups of 8 on the fallback
    t = shape[0] * shape[1]
    sg = 8 if group == 16 else t
    logits = x.reshape(-1, sg, p.d_model) @ params["router"]
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), p.top_k)
    load = np.asarray(jax.nn.one_hot(idx, p.n_experts).sum((1, 2)))
    cap = p_moe._capacity(sg, p)
    if "capacity_factor" in changes:
        assert load.max() > cap
    assert load.shape[0] == t // sg


def test_top_k_breaks_ties_to_the_lower_index():
    from repro_torch.models.moe import top_k
    probs = np.array([[0.2, 0.3, 0.2, 0.3, 0.0],
                      [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    pv, pi = top_k(torch.from_numpy(probs), 3)
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    assert np.array_equal(pv.numpy(), np.asarray(jv))
    assert pi.tolist() == [[1, 3, 0], [0, 1, 2]]


@pytest.mark.parametrize("q_lora_rank", [0, 24])
def test_mla_prefill_and_absorbed_decode_match_reference(q_lora_rank):
    """Prefill (decompressed through wkv_b) and one absorbed decode step
    against the padded latent cache, written in place at the index."""
    from repro.models import attention as j_attn
    from repro_torch.models import attention as p_attn
    j, p = _moe_pair("deepseek-v2-lite-16b", q_lora_rank=q_lora_rank)
    params = _np(j_attn._init_mla(jax.random.key(7), j))
    b, s, max_len = 2, 7, 12
    x = _draw(b, s, p.d_model, seed=8)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, jc = j_attn.mla_attention(params, jnp.asarray(x), j,
                                    positions=jnp.asarray(pos))
    blk = _block(params)
    got, pc = p_attn.mla_attention(blk, torch.from_numpy(x), p,
                                   positions=torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for k in ("latent", "k_rope"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-5, rtol=1e-5)
    # one decode step at cache_index = s against the padded caches
    jcache = {k: jnp.pad(v, ((0, 0), (0, max_len - s), (0, 0)))
              for k, v in jc.items()}
    pcache = p_lm.pad_caches({k: torch.from_numpy(np.array(v))
                              for k, v in jc.items()}, max_len)
    xs = _draw(b, 1, p.d_model, seed=9)
    step = np.full((b, 1), s, np.int32)
    want, jcache = j_attn.mla_attention(params, jnp.asarray(xs), j,
                                        positions=jnp.asarray(step),
                                        cache=jcache, cache_index=s)
    got, out_cache = p_attn.mla_attention(
        blk, torch.from_numpy(xs), p, positions=torch.from_numpy(step),
        cache=pcache, cache_index=s)
    assert out_cache is pcache                      # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for k in ("latent", "k_rope"):
        assert tuple(pcache[k].shape) == jcache[k].shape
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(jcache[k]),
                                   atol=1e-5, rtol=1e-5)


def _moe_engines(name, **changes):
    """A JAX engine and the port's engine on its carried weights."""
    key = (name, tuple(sorted(changes.items())))
    if key not in _ENGINES:
        j, p = _moe_pair(name, **changes)
        je = JEngine(j, dtype=jnp.float32, engine="vector",
                     attention_impl="registry", **ENGINE_KW)
        params = params_from_numpy(_np(je.params), p, device="cpu")
        pe = PEngine(p, dtype=torch.float32, engine="vector",
                     attention_impl="registry", params=params, device="cpu",
                     **ENGINE_KW)
        _ENGINES[key] = (je, pe)
    return _ENGINES[key]


#: the reduced MoE models, and reduced Qwen3 at 16 query heads over one KV
#: head: G = 16, the full model's group, through the registry decode
MOE_ENGINES = [(name, {}) for name in MOE] + [
    ("qwen3-moe-235b-a22b", {"n_heads": 16, "n_kv_heads": 1})]
MOE_ENGINE_IDS = ["deepseek-v2-lite", "qwen3-moe", "qwen3-moe-G16"]


@pytest.mark.parametrize("name,changes", MOE_ENGINES, ids=MOE_ENGINE_IDS)
def test_moe_engine_matches_reference_step_by_step(name, changes):
    """Prefill logits, every teacher-forced step's logits, the caches."""
    je, pe = _moe_engines(name, **changes)
    jb, pb = je.make_prompt_batch(seed=1), pe.make_prompt_batch(seed=1)
    jl, jc = je.prefill(jb)
    pl, pc = pe.prefill(pb)
    _close(pl, jl)
    assert sorted(pc) == sorted(jc)
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for i in range(je.prompt_len, je.max_len - 1):
        jl, jc = je.decode_step(jnp.asarray(tok), jc, i)
        pl, pc = pe.decode_step(torch.from_numpy(tok), pc, i)
        _close(pl, jl)
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1))[:, None]
    for group in jc:
        for k in jc[group]:
            assert tuple(pc[group][k].shape) == jc[group][k].shape
            _close(pc[group][k], jc[group][k])


@pytest.mark.parametrize("name,changes", MOE_ENGINES, ids=MOE_ENGINE_IDS)
def test_moe_engine_greedy_tokens_match_reference(name, changes):
    je, pe = _moe_engines(name, **changes)
    jr = je.generate(je.make_prompt_batch(seed=2))
    pr = pe.generate(pe.make_prompt_batch(seed=2))
    assert np.array_equal(pr.tokens.numpy(), np.asarray(jr.tokens))
    _close(pr.logits, jr.logits)


#: StableLM-2-12B's decode shape, reduced: its head dim 160 and its four
#: query heads per KV head (reduced keeps 4 heads; one KV head)
DH160 = {"head_dim": 160, "n_kv_heads": 1}


def _dh160_engines(engine):
    """reduced(stablelm-12b) at Dh 160, G 4: a JAX engine and the port's
    engine on its carried weights, decode attention through the
    registry's flash-decode."""
    key = ("stablelm-dh160", engine)
    if key not in _ENGINES:
        j, p = (dataclasses.replace(j_configs.reduced(c), **DH160)
                for c in _pair("stablelm-12b"))
        je = JEngine(j, dtype=jnp.float32, engine=engine,
                     attention_impl="registry", **ENGINE_KW)
        params = params_from_numpy(_np(je.params), p, device="cpu")
        pe = PEngine(p, dtype=torch.float32, engine=engine,
                     attention_impl="registry", params=params, device="cpu",
                     **ENGINE_KW)
        _ENGINES[key] = (je, pe)
    return _ENGINES[key]


@pytest.mark.parametrize("engine", ["vector", "matrix"])
def test_stablelm_head_dim_160_matches_reference_step_by_step(engine):
    """Prefill logits, every teacher-forced step's logits and the caches
    at StableLM-2-12B's head dim."""
    je, pe = _dh160_engines(engine)
    assert pe.cfg.head_dim == 160
    assert pe.cfg.n_heads // pe.cfg.n_kv_heads == 4
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
        assert tuple(pc["attn"][k].shape) == jc["attn"][k].shape
        _close(pc["attn"][k], jc["attn"][k])


@pytest.mark.parametrize("engine", ["vector", "matrix"])
def test_stablelm_head_dim_160_greedy_tokens_match_reference(engine):
    je, pe = _dh160_engines(engine)
    jr = je.generate(je.make_prompt_batch(seed=2))
    pr = pe.generate(pe.make_prompt_batch(seed=2))
    assert np.array_equal(pr.tokens.numpy(), np.asarray(jr.tokens))
    _close(pr.logits, jr.logits)


@pytest.mark.parametrize("name", MOE)
def test_teacher_forced_decode_equals_forward(name):
    """With the capacity lifted (drops exist only in the batched pass,
    as the reference's tests/test_arch_smoke.py lifts it), one decode
    step after prefill gives forward's logits over the prompt plus that
    token."""
    _, p = _moe_pair(name, capacity_factor=64.0)
    eng = PEngine(p, device="cpu", dtype=torch.float32, **ENGINE_KW)
    batch = eng.make_prompt_batch(seed=3)
    logits, caches = eng.prefill(batch)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    got, _ = eng.decode_step(tok, caches, eng.prompt_len)
    full = {"tokens": torch.cat([batch["tokens"], tok.to(
        batch["tokens"].dtype)], dim=1)}
    want, _, _ = p_lm.forward(eng.params, eng.cfg, full, dtype=torch.float32)
    torch.testing.assert_close(got[:, 0], want[:, -1], atol=1e-4, rtol=1e-3)


def test_mla_decode_runs_no_flash_decode(monkeypatch):
    """MLA layers decode in latent space: the registry op is never
    called, and the engine says so."""
    from repro_torch.kernels.attention import ops
    calls = []
    monkeypatch.setitem(ops.ATTENTION_OP.engines, "vector",
                        lambda *a, **k: calls.append(1))
    je, pe = _moe_engines("deepseek-v2-lite-16b")
    pe.generate(pe.make_prompt_batch(seed=6))
    assert calls == [] and pe.flash_decode_layers == 0
    _, qe = _moe_engines("qwen3-moe-235b-a22b")
    assert qe.flash_decode_layers == qe.cfg.n_layers


@pytest.mark.parametrize("name", MOE)
def test_moe_init_and_pad_caches_match_reference(name):
    from repro.models import lm as j_lm
    j, p = _moe_pair(name)
    jc = j_lm.init_caches(j, 2, 8, jnp.float32)
    pc = p_lm.init_caches(p, 2, 8, torch.float32, "cpu")
    assert sorted(pc) == sorted(jc)
    for group in jc:
        for k in jc[group]:
            assert tuple(pc[group][k].shape) == jc[group][k].shape
            assert not pc[group][k].any()
    short = {g: {k: jnp.ones(v[:, :, :5].shape) for k, v in c.items()}
             for g, c in jc.items()}
    want = j_lm.pad_caches(short, 8)
    got = p_lm.pad_caches({g: {k: torch.ones(v.shape) for k, v in c.items()}
                           for g, c in short.items()}, 8)
    for group in want:
        for k in want[group]:
            assert np.array_equal(got[group][k].numpy(),
                                  np.asarray(want[group][k]))


# --------------------------------------------------------------------------
# the SSM and hybrid families against the reference
# --------------------------------------------------------------------------

#: Two chunks of the reduced configs' 32: the chunked prefill runs its
#: inter-chunk recurrence.  Prompts longer than a chunk must be multiples
#: of it (the reference asserts so).
SSM_KW = dict(ENGINE_KW, prompt_len=64)
#: reduced mamba2-780m (4 SSM layers), and reduced zamba2-7b (7 layers,
#: attn_every 3: two super-blocks, each followed by the shared block, and
#: one tail layer) on both flash-decode engines and both attention paths
SSM_ENGINES = [("mamba2-780m", "vector", "registry")] + [
    ("zamba2-7b", e, impl) for e in ("vector", "matrix")
    for impl in ("registry", "dense")]
SSM_IDS = ["mamba2"] + [f"zamba2-{e}-{impl}" for _, e, impl in
                        SSM_ENGINES[1:]]


def _ssm_engines(name, engine, impl):
    """A JAX engine and the port's engine on its carried weights."""
    key = ("ssm", name, engine, impl)
    if key not in _ENGINES:
        j, p = (j_configs.reduced(c) for c in _pair(name))
        je = JEngine(j, dtype=jnp.float32, engine=engine,
                     attention_impl=impl, **SSM_KW)
        params = params_from_numpy(_np(je.params), p, device="cpu")
        pe = PEngine(p, dtype=torch.float32, engine=engine,
                     attention_impl=impl, params=params, device="cpu",
                     **SSM_KW)
        _ENGINES[key] = (je, pe)
    return _ENGINES[key]


def _close_caches(pc, jc):
    assert sorted(pc) == sorted(jc)
    for group in jc:
        assert sorted(pc[group]) == sorted(jc[group])
        for k in jc[group]:
            assert tuple(pc[group][k].shape) == jc[group][k].shape
            _close(pc[group][k], jc[group][k])


@pytest.mark.parametrize("name,engine,impl", SSM_ENGINES, ids=SSM_IDS)
def test_ssm_engine_matches_reference_step_by_step(name, engine, impl):
    """Prefill logits and caches (SSM states; the hybrid's KV caches per
    super-block and its tail), every teacher-forced step's logits, and
    the caches after the last step."""
    je, pe = _ssm_engines(name, engine, impl)
    jb, pb = je.make_prompt_batch(seed=1), pe.make_prompt_batch(seed=1)
    jl, jc = je.prefill(jb)
    pl, pc = pe.prefill(pb)
    _close(pl, jl)
    _close_caches(pc, jc)
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    for i in range(je.prompt_len, je.max_len - 1):
        jl, jc = je.decode_step(jnp.asarray(tok), jc, i)
        pl, pc = pe.decode_step(torch.from_numpy(tok), pc, i)
        _close(pl, jl)
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1))[:, None]
    _close_caches(pc, jc)


@pytest.mark.parametrize("name,engine,impl", SSM_ENGINES, ids=SSM_IDS)
def test_ssm_engine_greedy_tokens_match_reference(name, engine, impl):
    je, pe = _ssm_engines(name, engine, impl)
    jr = je.generate(je.make_prompt_batch(seed=2))
    pr = pe.generate(pe.make_prompt_batch(seed=2))
    assert np.array_equal(pr.tokens.numpy(), np.asarray(jr.tokens))
    _close(pr.logits, jr.logits)
    assert pr.decode_steps == jr.decode_steps == je.max_gen - 1


@pytest.mark.parametrize("name", SSM)
def test_ssm_forward_matches_reference(name):
    """forward over three chunks (96 tokens), the LM head on every
    position; no aux loss."""
    from repro.models import lm as j_lm
    je, pe = _ssm_engines(name, "vector", "registry")
    tokens = np.random.default_rng(4).integers(0, 512, (2, 96), np.int32)
    want, _, _ = j_lm.forward(je.params, je.cfg,
                              {"tokens": jnp.asarray(tokens)},
                              dtype=jnp.float32, remat=False)
    got, caches, aux = p_lm.forward(pe.params, pe.cfg,
                                    {"tokens": torch.from_numpy(tokens)},
                                    dtype=torch.float32)
    _close(got, want)
    assert caches is None and float(aux["aux_loss"]) == 0.0


@pytest.mark.parametrize("name", SSM)
def test_ssm_prompt_off_the_chunk_raises_as_the_reference(name):
    """A prompt longer than a chunk that is not a multiple of it: the
    reference's assertion (32, 40), kept; the port pads nothing."""
    je, pe = _ssm_engines(name, "vector", "registry")
    tokens = np.zeros((1, 40), np.int32)
    with pytest.raises(AssertionError, match="40, 32"):
        je.prefill({"tokens": jnp.asarray(tokens)})
    with pytest.raises(AssertionError, match="40, 32"):
        pe.prefill({"tokens": torch.from_numpy(tokens)})


@pytest.mark.parametrize("name", SSM)
def test_ssm_init_and_pad_caches_match_reference(name):
    """Zero states and KV caches with the reference's structure, shapes
    and dtypes (SSM states float32 whatever the KV dtype); pad_caches
    grows the KV caches and leaves the states as they are."""
    from repro.models import lm as j_lm
    j, p = (j_configs.reduced(c) for c in _pair(name))
    jc = j_lm.init_caches(j, 2, 8, jnp.bfloat16)
    pc = p_lm.init_caches(p, 2, 8, torch.bfloat16, "cpu")
    assert sorted(pc) == sorted(jc)
    for group in jc:
        assert sorted(pc[group]) == sorted(jc[group])
        for k in jc[group]:
            assert tuple(pc[group][k].shape) == jc[group][k].shape
            assert str(pc[group][k].dtype).split(".")[-1] == \
                jc[group][k].dtype.name
            assert not pc[group][k].any()
    short = {g: {k: jnp.ones(v[:, :, :5].shape if k in ("k", "v")
                             else v.shape, jnp.float32)
                 for k, v in c.items()} for g, c in jc.items()}
    want = j_lm.pad_caches(short, 8)
    got = p_lm.pad_caches({g: {k: torch.ones(v.shape) for k, v in c.items()}
                           for g, c in short.items()}, 8)
    for group in want:
        for k in want[group]:
            assert np.array_equal(got[group][k].numpy(),
                                  np.asarray(want[group][k]))


def test_ssm_cache_state_is_a_snapshot_matching_reference():
    """decode_step writes the SSM and conv states (and the hybrid's KV
    caches) in place: a state taken after prefill stays that of prefill,
    equal to the reference's at the same point, and a loaded state is a
    copy the next step does not write through."""
    je, pe = _ssm_engines("zamba2-7b", "vector", "registry")
    jlogits, jcaches = je.prefill(je.make_prompt_batch(seed=8))
    plogits, pcaches = pe.prefill(pe.make_prompt_batch(seed=8))
    jstate, pstate = je.cache_state(jcaches), pe.cache_state(pcaches)
    loaded = pe.load_cache_state(pcaches, pstate)
    ptok = torch.argmax(plogits[:, -1], dim=-1)[:, None]
    pe.decode_step(ptok, pcaches, pe.prompt_len)
    pe.decode_step(ptok, loaded, pe.prompt_len)
    for group in ("ssm", "tail"):
        for k in ("ssm", "conv_x", "conv_bc"):
            assert not torch.equal(pcaches[group][k], pstate[group][k])
            assert torch.equal(loaded[group][k], pcaches[group][k])
            _close(pstate[group][k], jstate[group][k])
    assert not torch.equal(loaded["attn"]["k"], pstate["attn"]["k"])
    bad = dict(pstate, tail={k: v[:0] for k, v in pstate["tail"].items()})
    with pytest.raises(ValueError, match="mismatch"):
        pe.load_cache_state(pcaches, bad)


def test_ssm_decode_launches_flash_decode_per_super_block(monkeypatch):
    """Zamba2's shared block runs the registry's flash-decode once per
    super-block and step; Mamba2 runs none, and the engines say so."""
    from repro_torch.kernels.attention import ops
    calls = []
    original = ops.ATTENTION_OP.engines["vector"]

    def spy(*args, **kwargs):
        calls.append(kwargs["backend"])
        return original(*args, **kwargs)
    monkeypatch.setitem(ops.ATTENTION_OP.engines, "vector", spy)
    _, ze = _ssm_engines("zamba2-7b", "vector", "registry")
    ze.generate(ze.make_prompt_batch(seed=6))
    n_super = ze.cfg.n_layers // ze.cfg.attn_every
    assert ze.flash_decode_layers == n_super == 2
    assert calls == ["plain"] * (n_super * (ze.max_gen - 1))
    calls.clear()
    _, me = _ssm_engines("mamba2-780m", "vector", "registry")
    me.generate(me.make_prompt_batch(seed=6))
    assert calls == [] and me.flash_decode_layers == 0
    _, dense = _ssm_engines("zamba2-7b", "vector", "dense")
    assert dense.flash_decode_layers == 0


@pytest.mark.parametrize("name", SSM)
def test_ssm_bfloat16_engine_runs_on_cast_weights(name):
    cfg = p_configs.reduced(p_configs.get_arch(name))
    eng = PEngine(cfg, dtype=torch.bfloat16, device="cpu", **SSM_KW)
    out = eng.generate(eng.make_prompt_batch(seed=8))
    assert out.logits.dtype == torch.bfloat16
    assert torch.isfinite(out.logits.float()).all()
    assert out.caches["ssm"]["ssm"].dtype == torch.float32
    if cfg.family == "hybrid":
        assert out.caches["attn"]["k"].dtype == torch.bfloat16


def test_ssm_executor_matches_reference():
    """The serving executor on reduced Zamba2: the reference's engine,
    shards, decode steps and launches, and its verdict at full size."""
    j, p = (j_configs.reduced(c) for c in _pair("zamba2-7b"))
    jfull, pfull = _pair("zamba2-7b")
    kw = dict(max_batch=2, prompt_len=32, max_gen=4, engine="vector")
    je = JExecutor(j, dtype=jnp.float32, verdict_cfg=jfull, **kw)
    pe = PExecutor(p, dtype=torch.float32, verdict_cfg=pfull, device="cpu",
                   **kw)
    jreqs = [JRequest(rid=i, kernel="lm-decode", arrival_s=0.0, size=4)
             for i in range(2)]
    preqs = [PRequest(rid=i, kernel="lm-decode", arrival_s=0.0, size=4)
             for i in range(2)]
    jx, px = je.execute(jreqs), pe.execute(preqs)
    assert px.engine == jx.engine and px.shards == jx.shards
    jr, pr = je.record_extras(), pe.record_extras()
    assert pr["model"] == jr["model"]
    assert pr["phases"]["decode_steps"] == jr["phases"]["decode_steps"]
    assert pr["phases"]["launches"] == jr["phases"]["launches"]
    assert [o["name"] for o in pr["verdict"]["ops"]] == \
        [o["name"] for o in jr["verdict"]["ops"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["vector", "matrix"])
def test_card_ssm_families_launch_flash_decode_per_super_block(card, engine):
    """On the card, reduced Zamba2 launches the engine's flash-decode
    kernel once per super-block and decode step, the other engine's
    never, and its greedy tokens are the dense-attention path's; reduced
    Mamba2 launches none."""
    from repro_torch.kernels import _ext
    other = "matrix" if engine == "vector" else "vector"
    for name in SSM:
        cfg = p_configs.reduced(p_configs.get_arch(name))
        eng = PEngine(cfg, dtype=torch.float32, engine=engine, device=card,
                      **SSM_KW)
        batch = eng.make_prompt_batch(seed=9)
        eng.warmup(batch)
        _ext.reset_launches()
        got = eng.generate(batch)
        steps = eng.max_gen - 1
        assert _ext.LAUNCHES.get(f"attention_{engine}", 0) == \
            eng.flash_decode_layers * steps
        assert _ext.LAUNCHES.get(f"attention_{other}", 0) == 0
        ref = PEngine(cfg, dtype=torch.float32, engine=engine,
                      attention_impl="dense", params=eng.params, device=card,
                      **SSM_KW)
        want = ref.generate(batch)
        assert torch.equal(got.tokens, want.tokens)
        torch.testing.assert_close(got.logits, want.logits, atol=1e-4,
                                   rtol=1e-3)
