"""The Mamba2 (SSD) layer: the port's ``models/ssm.py`` against the reference.

The reference runs as its own tests run it (``jax_platform_name=cpu``);
the port runs on the CPU.  Inputs are numpy draws from a seed, and the
reference's weights (``init_ssm``) cross into the port bit for bit.

Tolerance: every float32 comparison holds |a - b| <= 1e-4 + 1e-3 |b|, the
model tier of ``tests/test_model_engine.py``.  The conv, the chunked scan
and the layer differ from the reference by a few float32 ulps: summation
order inside the matmuls and einsums, and XLA's fused multiply-adds in
the conv's sum.  Shapes, dtypes and the initial values that are not
random are exact.
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
from repro.models import ssm as j_ssm  # noqa: E402

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.models import ssm as p_ssm  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ATOL, RTOL = 1e-4, 1e-3


def _close(got, want):
    """Hold ``got`` to ``want``; print the largest gap (``pytest -s``)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    gap = np.abs(got - want)
    print(f"max |a - b| {gap.max():.3g}, max |a - b| / (1 + |b|) "
          f"{(gap / (1 + np.abs(want))).max():.3g}")


def _draw(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _cfgs(**changes):
    """reduced(mamba2-780m): d_model 128, d_inner 256, 8 SSM heads of 32,
    state 16, chunk 32; ``changes`` applied to both packages' configs."""
    j, p = (dataclasses.replace(c.reduced(c.get_arch("mamba2-780m")),
                                **changes)
            for c in (j_configs, p_configs))
    return j, p


def _weights(cfg, seed=0):
    """The reference's init_ssm as numpy, and as the port's Block."""
    tree = jax.tree.map(np.asarray, j_ssm.init_ssm(jax.random.key(seed),
                                                    cfg))
    return tree, p_lm.Block({k: torch.from_numpy(v.copy())
                             for k, v in tree.items()})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# parameters and state
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ngroups", [1, 2])
def test_init_ssm_matches_reference_layout(ngroups):
    """The reference's names, shapes and dtypes; its deterministic values
    (a_log, d_skip, norm, zero biases) equal; dt_bias the inverse softplus
    of a dt in [1e-3, 1e-1]."""
    j, p = _cfgs(ssm_ngroups=ngroups)
    want = j_ssm.init_ssm(jax.random.key(0), j)
    gen = torch.Generator().manual_seed(0)
    got = p_ssm.init_ssm(gen, p, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == torch.float32 and v.dtype == jnp.float32
    for k in ("a_log", "d_skip", "norm", "conv_x_b", "conv_bc_b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert bool(((dt > 1e-3 * 0.999) & (dt < 1e-1 * 1.001)).all())
    again = p_ssm.init_ssm(torch.Generator().manual_seed(0), p, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("batch", [1, 3])
def test_make_ssm_state_matches_reference(batch):
    j, p = _cfgs()
    want = j_ssm.make_ssm_state(j, batch)
    got = p_ssm.make_ssm_state(p, batch, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert got[k].dtype == torch.float32 and v.dtype == jnp.float32
        assert not got[k].any()


# --------------------------------------------------------------------------
# the causal conv
# --------------------------------------------------------------------------

CONV_CASES = [(7, False), (7, True), (1, True)]


@pytest.mark.parametrize("seq,tail", CONV_CASES,
                         ids=["prefill", "prefill-with-tail", "decode"])
def test_causal_conv_matches_reference(seq, tail):
    """Width-4 depthwise conv over (B, S, C), from zeros or from a carried
    (B, K-1, C) tail; the output and the new tail."""
    x = _draw(2, seq, 24, seed=1)
    w = _draw(4, 24, seed=2, scale=0.1)
    b = _draw(24, seed=3)
    st = _draw(2, 3, 24, seed=4) if tail else None
    want, wtail = j_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, gtail = p_ssm._causal_conv(_t(x), _t(w), _t(b),
                                    None if st is None else _t(st))
    _close(got, want)
    assert np.array_equal(gtail.numpy(), np.asarray(wtail))


# --------------------------------------------------------------------------
# the chunked scan
# --------------------------------------------------------------------------

def _scan_inputs(seq, heads, groups, seed=0):
    b, p, n = 2, 8, 16
    x = _draw(b, seq, heads, p, seed=seed)
    dt = np.exp(_draw(b, seq, heads, seed=seed + 1, scale=0.5) - 2.0)
    a = np.linspace(1.0, 4.0, heads, dtype=np.float32)
    bm = _draw(b, seq, groups, n, seed=seed + 2, scale=0.5)
    cm = _draw(b, seq, groups, n, seed=seed + 3, scale=0.5)
    return x, dt.astype(np.float32), a, bm, cm


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_ssd_chunked_matches_reference(n_chunks, groups):
    """y and the final state at 1, 2 and 4 chunks of 8, with one group
    (b and c shared by every head) and two (each over half the heads)."""
    chunk = 8
    args = _scan_inputs(chunk * n_chunks, 4, groups)
    want_y, want_s = j_ssm._ssd_chunked(*map(jnp.asarray, args), chunk)
    got_y, got_s = p_ssm._ssd_chunked(*map(_t, args), chunk)
    _close(got_y, want_y)
    _close(got_s, want_s)


def test_ssd_chunked_survives_large_decay():
    """A decay so steep that exp(-seg) overflows in the masked upper
    triangle: the output stays finite and equal to the reference."""
    x, dt, a, bm, cm = _scan_inputs(16, 4, 1, seed=5)
    dt = dt * 200.0
    want_y, want_s = j_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)),
                                        16)
    got_y, got_s = p_ssm._ssd_chunked(*map(_t, (x, dt, a, bm, cm)), 16)
    assert np.isfinite(np.asarray(want_y)).all()
    assert torch.isfinite(got_y).all()
    _close(got_y, want_y)
    _close(got_s, want_s)


def test_ssd_chunked_refuses_a_partial_chunk():
    args = _scan_inputs(12, 4, 1)
    with pytest.raises(AssertionError):
        j_ssm._ssd_chunked(*map(jnp.asarray, args), 8)
    with pytest.raises(AssertionError):
        p_ssm._ssd_chunked(*map(_t, args), 8)


# --------------------------------------------------------------------------
# the layer: chunked prefill and the recurrent step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [8, 32, 64])
@pytest.mark.parametrize("ngroups", [1, 2])
def test_ssm_layer_prefill_matches_reference(seq, ngroups):
    """Inside one chunk (8), one whole chunk (32) and two (64): the
    output and the state (SSM state, both conv tails)."""
    j, p = _cfgs(ssm_ngroups=ngroups)
    tree, blk = _weights(j, seed=1)
    x = _draw(2, seq, p.d_model, seed=2)
    want, wst = j_ssm.ssm_layer(tree, jnp.asarray(x), j)
    got, gst = p_ssm.ssm_layer(blk, _t(x), p)
    _close(got, want)
    assert sorted(gst) == sorted(wst)
    for k in wst:
        _close(gst[k], wst[k])


@pytest.mark.parametrize("ngroups", [1, 2])
def test_ssm_layer_recurrent_step_matches_reference(ngroups):
    """One token from a carried state (the reference's prefill state,
    crossed as numpy): the output and the new state; the state given is
    left as it was."""
    j, p = _cfgs(ssm_ngroups=ngroups)
    tree, blk = _weights(j, seed=3)
    _, wst = j_ssm.ssm_layer(tree, jnp.asarray(_draw(2, 32, p.d_model,
                                                     seed=4)), j)
    state = {k: np.asarray(v) for k, v in wst.items()}
    x1 = _draw(2, 1, p.d_model, seed=5)
    want, wnew = j_ssm.ssm_layer(tree, jnp.asarray(x1), j,
                                 state={k: jnp.asarray(v)
                                        for k, v in state.items()})
    pst = {k: _t(v.copy()) for k, v in state.items()}
    got, gnew = p_ssm.ssm_layer(blk, _t(x1), p, state=pst)
    _close(got, want)
    for k in wnew:
        _close(gnew[k], wnew[k])
        assert np.array_equal(pst[k].numpy(), state[k])


@pytest.mark.parametrize("bias", [-25.0, 19.5, 20.0, 20.5, 30.0])
def test_ssm_layer_softplus_edge_matches_reference(bias):
    """dt = softplus(x W_dt + dt_bias) around PyTorch's threshold of 20,
    where ``F.softplus`` turns into the identity and ``jax.nn.softplus``
    does not, and far on either side: prefill and one recurrent step."""
    j, p = _cfgs()
    tree, _ = _weights(j, seed=6)
    tree = dict(tree, dt_bias=np.full_like(tree["dt_bias"], bias),
                w_dt=tree["w_dt"] * np.float32(0.01))
    blk = p_lm.Block({k: _t(v.copy()) for k, v in tree.items()})
    x = _draw(2, 32, p.d_model, seed=7)
    want, wst = j_ssm.ssm_layer(tree, jnp.asarray(x), j)
    got, gst = p_ssm.ssm_layer(blk, _t(x), p)
    _close(got, want)
    x1 = _draw(2, 1, p.d_model, seed=8)
    want1, _ = j_ssm.ssm_layer(tree, jnp.asarray(x1), j, state=wst)
    got1, _ = p_ssm.ssm_layer(blk, _t(x1), p, state=gst)
    _close(got1, want1)


@pytest.mark.parametrize("batch", [1, 2])
def test_chunked_prefill_equals_recurrent_steps(batch):
    """On the port alone: a prefill of 32 tokens then 32 recurrent steps
    give the outputs and the final state of the chunked pass over all 64
    (two chunks), position by position.

    One group, as every config has: with more, the reference's recurrent
    step sums b and c over the groups where its chunked scan gives each
    head its own group's, so the two forms differ there, in the reference
    as in the port (``test_groups_split_the_two_forms_as_the_reference``).
    """
    _, p = _cfgs()
    blk = p_lm.Block(p_ssm.init_ssm(torch.Generator().manual_seed(9), p,
                                    device="cpu"))
    x = torch.from_numpy(_draw(batch, 64, p.d_model, seed=10))
    full, fst = p_ssm.ssm_layer(blk, x, p)
    out, st = p_ssm.ssm_layer(blk, x[:, :32], p)
    steps = [out]
    for i in range(32, 64):
        y, st = p_ssm.ssm_layer(blk, x[:, i:i + 1], p, state=st)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, atol=ATOL,
                               rtol=RTOL)
    for k in fst:
        torch.testing.assert_close(st[k], fst[k], atol=ATOL, rtol=RTOL)


def test_groups_split_the_two_forms_as_the_reference():
    """At two groups the recurrent step (b and c summed over the groups)
    and the chunked scan (each head its group's) disagree by the same
    amount in both packages: a fact of the reference, kept."""
    j, p = _cfgs(ssm_ngroups=2)
    tree, blk = _weights(j, seed=13)
    x = _draw(2, 33, p.d_model, seed=14)
    jfull, _ = j_ssm.ssm_layer(tree, jnp.asarray(x[:, :32]), j)
    _, jst = j_ssm.ssm_layer(tree, jnp.asarray(x[:, :31]), j)
    jstep, _ = j_ssm.ssm_layer(tree, jnp.asarray(x[:, 31:32]), j, state=jst)
    _, pst = p_ssm.ssm_layer(blk, _t(x[:, :31]), p)
    pstep, _ = p_ssm.ssm_layer(blk, _t(x[:, 31:32]), p, state=pst)
    _close(pstep, jstep)
    gap = np.abs(np.asarray(jstep) - np.asarray(jfull)[:, -1:]).max()
    assert gap > 1e-2


def test_ssm_layer_refuses_a_partial_chunk_as_the_reference():
    """40 tokens against a chunk of 32: the reference's assertion, kept
    (no padding)."""
    j, p = _cfgs()
    tree, blk = _weights(j)
    x = _draw(1, 40, p.d_model, seed=11)
    with pytest.raises(AssertionError, match="40, 32"):
        j_ssm.ssm_layer(tree, jnp.asarray(x), j)
    with pytest.raises(AssertionError, match="40, 32"):
        p_ssm.ssm_layer(blk, _t(x), p)


def test_ssm_layer_runs_in_bfloat16_with_float32_state():
    """The bfloat16 path on cast weights: bfloat16 output, float32 state,
    finite, near the float32 output."""
    _, p = _cfgs()
    layer = p_lm.init_params(p, seed=0, device="cpu")
    cast = p_lm.cast_params(layer, torch.bfloat16).layers[0].ssm
    x = torch.from_numpy(_draw(2, 32, p.d_model, seed=12))
    y32, _ = p_ssm.ssm_layer(layer.layers[0].ssm, x, p)
    y16, st = p_ssm.ssm_layer(cast, x.to(torch.bfloat16), p)
    assert y16.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in st.values())
    assert torch.isfinite(y16.float()).all()
    assert (y16.float() - y32).abs().max() < 0.1 * y32.abs().max()
