"""``launch/steps``' prefill and decode steps against the reference's.

The port's steps take the float32 parameters that ``lm.init_params``
returns and cast them once, on the first call with them
(``lm.cast_params``), where the reference casts at each use; both steps run at their default bfloat16
and at float32, on every config's ``reduced`` form, from the same
carried weights and inputs.  The decode step starts from the
reference's prefill caches (the same values on both sides) and takes its
index as a Python int or a 0-d tensor with a value; a meta index (what
``decode_input_specs`` gives) is refused.

Tolerances: float32 |a - b| <= 1e-4 + 1e-3 |b|; bfloat16 logits within
``BF16_ULPS`` bfloat16 ulps at the binade of the reference's largest
logit.  The two packages round different bfloat16 intermediates (XLA's
fused elementwise chains against PyTorch's op by op), and the gap grows
with depth: measured 1.5-4.75 ulps over the reduced configs, the worst
Zamba2's 7 layers; one ulp holds for none of them.
"""
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
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.carry import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH_NAMES = sorted(j_configs.ARCHS)
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}
B, PROMPT, MAX_LEN = 2, 8, 16
BF16_ULPS = 8


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _torch(tree, dtype):
    """The reference's cache tree as the port's, leaf for leaf (float
    leaves in ``dtype``: exact, they were ``dtype`` there)."""
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(jnp.asarray(tree, jnp.float32)))
    return t if tree.dtype == jnp.float32 else t.to(dtype)


def _assert_close(got: torch.Tensor, want, dtype: str, what: str):
    a = got.float().numpy().astype(np.float64)
    b = _np(want).astype(np.float64)
    assert a.shape == b.shape, what
    if dtype == "bfloat16":
        ulp = 2.0 ** (np.floor(np.log2(np.abs(b).max())) - 7)
        err = np.abs(a - b).max()
        assert err <= BF16_ULPS * ulp, (what, err / ulp)
    else:
        bad = np.abs(a - b) > 1e-4 + 1e-3 * np.abs(b)
        assert not bad.any(), (what, np.abs(a - b).max())


def _setup(name):
    jcfg = j_configs.reduced(j_configs.get_arch(name))
    pcfg = p_configs.reduced(p_configs.get_arch(name))
    params = j_lm.init_params(jcfg, jax.random.key(0))
    p = params_from_numpy(jax.tree.map(np.asarray, params), pcfg,
                          device="cpu")
    batch = dict(j_make_batch(jcfg, B, PROMPT, seed=1))
    pbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jcfg, pcfg, params, p, batch, pbatch


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_step_on_float32_params_matches_reference(name, dtype):
    jdt, pdt = DTYPES[dtype]
    jcfg, pcfg, params, p, batch, pbatch = _setup(name)
    jlogits, _ = j_steps.make_prefill_step(jcfg, dtype=jdt)(params, batch)
    assert next(p.parameters()).dtype == torch.float32
    logits, caches = p_steps.make_prefill_step(pcfg, dtype=pdt)(p, pbatch)
    assert logits.dtype == pdt
    _assert_close(logits, jlogits, dtype, f"{name} prefill")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_step_on_float32_params_matches_reference(name, dtype):
    jdt, pdt = DTYPES[dtype]
    jcfg, pcfg, params, p, batch, pbatch = _setup(name)
    _, jcaches = j_steps.make_prefill_step(jcfg, dtype=jdt)(params, batch)
    jcaches = j_lm.pad_caches(jcaches, MAX_LEN)
    caches = _torch(jcaches, pdt)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (B, 1),
                                               dtype=np.int32)
    jlogits, _ = j_steps.make_decode_step(jcfg, dtype=jdt)(
        params, jnp.asarray(tokens), jcaches, jnp.int32(PROMPT))
    # a 0-d index tensor with a value, as a caller holding one passes it
    logits, _ = p_steps.make_decode_step(pcfg, dtype=pdt)(
        p, torch.from_numpy(tokens), caches, torch.tensor(PROMPT))
    _assert_close(logits, jlogits, dtype, f"{name} decode")


def test_decode_step_takes_an_int_index_and_refuses_a_meta_one():
    jcfg, pcfg, params, p, batch, pbatch = _setup("mistral-nemo-12b")
    step = p_steps.make_decode_step(pcfg, dtype=torch.float32)
    caches = p_lm.init_caches(pcfg, B, MAX_LEN, dtype=torch.float32,
                              device="cpu")
    tokens = torch.zeros((B, 1), dtype=torch.int32)
    by_int, _ = step(p, tokens, caches, 3)
    caches = p_lm.init_caches(pcfg, B, MAX_LEN, dtype=torch.float32,
                              device="cpu")
    by_tensor, _ = step(p, tokens, caches, torch.tensor(3))
    assert torch.equal(by_int, by_tensor)
    with pytest.raises(ValueError, match="hold a value"):
        step(p, tokens, caches, torch.empty((), dtype=torch.int32,
                                            device="meta"))


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "deepseek-v2-lite-16b"])
def test_steps_run_at_their_default_dtype_on_abstract_params(name):
    """The fault the repair closes: the default bfloat16 steps on the
    float32 parameters of ``abstract_params`` (meta), prefill and decode."""
    from repro_torch.launch.cells import Cell
    cfg = p_configs.reduced(p_configs.get_arch(name))
    params = p_lm.abstract_params(cfg)
    cell = Cell("small", "prefill", 16, 2)
    logits, _ = p_steps.make_prefill_step(cfg)(
        params, p_steps.input_specs(cfg, cell))
    assert logits.dtype == torch.bfloat16 and logits.is_meta
    tokens, caches, _ = p_steps.decode_input_specs(
        cfg, Cell("small", "decode", 16, 2))
    logits, _ = p_steps.make_decode_step(cfg)(params, tokens, caches, 15)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_padded) or \
        tuple(logits.shape)[:2] == (2, 1)


def test_serving_steps_cast_the_weights_once(monkeypatch):
    """A step casts a parameter tree on its first call and reuses the
    cast: a decode step does not copy every float32 weight per token."""
    from repro_torch.launch.cells import Cell
    cfg = p_configs.reduced(p_configs.get_arch("mistral-nemo-12b"))
    params = p_lm.abstract_params(cfg)
    casts = []
    real = p_lm.cast_params
    monkeypatch.setattr(p_lm, "cast_params",
                        lambda p, dtype: casts.append(p) or real(p, dtype))
    step = p_steps.make_decode_step(cfg)
    for index in (13, 14, 15):
        tokens, caches, _ = p_steps.decode_input_specs(
            cfg, Cell("small", "decode", 16, 2))
        step(params, tokens, caches, index)
    assert casts == [params]
    other = p_lm.abstract_params(cfg)          # a new tree: cast anew
    step(other, tokens, caches, 15)
    assert casts == [params, other]
    prefill = p_steps.make_prefill_step(cfg)
    batch = p_steps.input_specs(cfg, Cell("small", "prefill", 16, 2))
    prefill(params, batch)
    prefill(params, batch)
    assert casts == [params, other, params]
    p_steps.make_decode_step(cfg, dtype=torch.float32)(params, tokens,
                                                        caches, 15)
    assert len(casts) == 3                     # float32: nothing to cast
