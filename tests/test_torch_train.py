"""Training: the port against the reference.

``loss_fn`` and its gradients (every config's ``reduced`` form), remat,
AdamW and its schedule, gradient compression, ``TokenPipeline``,
``runtime/checkpoint`` (either package restores the other's
checkpoints), the restart drill, ``launch/{cells,steps,train}`` and a
decode cache checkpointed mid-generation.  The reference runs on the
CPU at float32 as its own tests run it; the port on the CPU.  Weights,
gradients and optimizer states cross as numpy, bit for bit
(``carry``).

Tolerances, each where it is used:
* the loss and its metrics 1e-5; each gradient leaf within 5e-5 of its
  largest magnitude (autograd and XLA sum the backward's products in
  different orders; the observed worst is 1.2e-5);
* AdamW from the *reference's* gradients: the moments and parameters
  within 2e-6 relative (the global norm sums per layer here, per stacked
  group there, so the clip scale differs in its last bits);
* the schedule, the gold logit, compression, batches, checkpoints and
  the restart drill bit for bit.
"""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on shared cores: one
# intra-op thread each keeps these CPU tests from crowding the others
torch.set_num_threads(1)

from repro import configs as j_configs  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipeline  # noqa: E402
from repro.data.synthetic import make_batch as j_make_batch  # noqa: E402
from repro.launch import cells as j_cells  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import compression as j_comp  # noqa: E402
from repro.runtime import checkpoint as j_ckpt  # noqa: E402

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.carry import (adamw_state_from_numpy,  # noqa: E402
                               adamw_state_to_numpy, params_from_numpy,
                               params_to_numpy, stacked_axes)
from repro_torch.data.pipeline import TokenPipeline as PPipeline  # noqa: E402
from repro_torch.launch import cells as p_cells  # noqa: E402
from repro_torch.launch import steps as p_steps  # noqa: E402
from repro_torch.launch import train as p_train  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.models.engine import DecodeEngine as PEngine  # noqa: E402
from repro_torch.optim import adamw as p_adamw  # noqa: E402
from repro_torch.optim import compression as p_comp  # noqa: E402
from repro_torch.optim.tree import leaves, named_leaves  # noqa: E402
from repro_torch.runtime import checkpoint as p_ckpt  # noqa: E402
from repro_torch.runtime.train_loop import (FailureInjector,  # noqa: E402
                                            StragglerWatchdog,
                                            TrainLoopConfig, run)

jax.config.update("jax_platform_name", "cpu")

ARCH_NAMES = sorted(j_configs.ARCHS)
LOSS_ATOL, GRAD_REL, ADAM_RTOL = 1e-5, 5e-5, 2e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reduced(name):
    return (j_configs.reduced(j_configs.get_arch(name)),
            p_configs.reduced(p_configs.get_arch(name)))


def _batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaves_with_keys(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_tree_close(got, want, rel, what):
    """Each leaf of the reference-layout ``got`` within ``rel`` of the
    largest magnitude of ``want``'s leaf."""
    g = dict(_leaves_with_keys(got))
    w = dict(_leaves_with_keys(want))
    assert sorted(g) == sorted(w), what
    for key, b in w.items():
        a = g[key]
        assert a.shape == b.shape, (what, key)
        err = np.abs(a.astype(np.float64) - b).max() if b.size else 0.0
        assert err <= rel * max(np.abs(b).max(), 1e-30), (what, key, err)


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------

#: (loss_chunks, mask): the pipeline's own mask (zero over a vision
#: config's patches); four chunks of the sequence under a random mask.
LOSS_VARIANTS = {"whole": (0, None), "chunked-masked": (4, 5)}


@pytest.mark.parametrize("variant", sorted(LOSS_VARIANTS))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_grads_match_reference(name, variant):
    chunks, mask_seed = LOSS_VARIANTS[variant]
    jcfg, pcfg = _reduced(name)
    params = j_lm.init_params(jcfg, jax.random.key(0))
    batch = dict(j_make_batch(jcfg, 2, 32, seed=1))
    if mask_seed is not None:
        batch["loss_mask"] = jnp.asarray(
            np.random.default_rng(mask_seed).integers(0, 2, (2, 32)),
            jnp.float32)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_lm.loss_fn(p, jcfg, batch, dtype=jnp.float32,
                               loss_chunks=chunks), has_aux=True)(params)
    p = params_from_numpy(_np(params), pcfg, device="cpu")
    (loss, metrics), grads = p_steps.make_value_and_grad(
        pcfg, dtype=torch.float32, loss_chunks=chunks)(p, _batch(batch))
    assert abs(float(loss) - float(jl)) <= LOSS_ATOL
    assert sorted(metrics) == sorted(jm)
    for k, v in jm.items():
        assert abs(float(metrics[k]) - float(v)) <= LOSS_ATOL, k
    _assert_tree_close(params_to_numpy(grads), _np(jg), GRAD_REL, name)


def test_gold_logit_gather_equals_one_hot_contraction():
    """The port gathers the gold logit; the reference contracts a one-hot,
    whose other terms add exact zeros: the same value, bit for bit."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    one_hot = np.asarray(jnp.einsum(
        "bsv,bsv->bs", jnp.asarray(logits), jax.nn.one_hot(
            jnp.asarray(labels), 50, dtype=jnp.float32)))
    gathered = torch.gather(torch.from_numpy(logits), -1, torch.from_numpy(
        labels).long()[..., None])[..., 0].numpy()
    np.testing.assert_array_equal(gathered, one_hot)
    np.testing.assert_allclose(
        p_lm._nll(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(j_lm._nll(jnp.asarray(logits), jnp.asarray(labels), 50)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["mistral-nemo-12b", "qwen3-moe-235b-a22b",
                                  "zamba2-7b", "seamless-m4t-large-v2"])
def test_remat_changes_no_value(name):
    """Each layer recomputed in the backward pass, or its matmuls kept
    ("dots"), or nothing recomputed: the same loss and gradients, bit for
    bit."""
    _, pcfg = _reduced(name)
    p = p_lm.init_params(pcfg, seed=2, device="cpu")
    batch = _batch(j_make_batch(j_configs.reduced(j_configs.get_arch(name)),
                                2, 32, seed=4))
    out = {}
    for remat, policy in ((False, None), (True, None), (True, "dots")):
        (loss, _), grads = p_steps.make_value_and_grad(
            pcfg, dtype=torch.float32, remat=remat,
            remat_policy=policy)(p, batch)
        out[(remat, policy)] = (loss, dict(grads.named_parameters()))
    (l0, g0), *rest = out.values()
    for loss, grads in rest:
        assert torch.equal(loss, l0)
        assert all(torch.equal(grads[n], g) for n, g in g0.items())


@pytest.mark.parametrize("cast", [False, True])
def test_bf16_loss_tracks_reference(cast):
    """At bfloat16 (each weight cast to it, norms too with
    ``cast_params``) the loss is the reference's within bfloat16's
    rounding of the two packages' different matmul orders: 2e-2."""
    jcfg, pcfg = _reduced("mistral-nemo-12b")
    params = j_lm.init_params(jcfg, jax.random.key(0))
    batch = j_make_batch(jcfg, 2, 16, seed=1)
    jp = jax.tree.map(lambda w: w.astype(jnp.bfloat16), params) if cast \
        else params
    want, _ = j_lm.loss_fn(jp, jcfg, batch, dtype=jnp.bfloat16)
    p = params_from_numpy(_np(params), pcfg, device="cpu")
    (loss, _), grads = p_steps.make_value_and_grad(
        pcfg, dtype=torch.bfloat16, cast_params=cast)(p, _batch(batch))
    assert abs(float(loss) - float(want)) <= 2e-2
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads.parameters())


# --------------------------------------------------------------------------
# AdamW, the schedule, compression
# --------------------------------------------------------------------------

def test_cosine_schedule_and_global_norm_match_reference():
    j = j_adamw.cosine_schedule(3e-4, 4, 12)
    p = p_adamw.cosine_schedule(3e-4, 4, 12)
    for c in range(16):
        want = np.asarray(j(jnp.int32(c)))
        got = p(torch.tensor(c, dtype=torch.int32)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(c))
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    got = p_adamw.global_norm({"a": torch.from_numpy(tree["a"]), "b": {
        "c": torch.from_numpy(tree["b"]["c"])}})
    np.testing.assert_allclose(float(got), float(j_adamw.global_norm(tree)),
                               rtol=1e-6)


def test_adamw_matches_reference_over_three_steps():
    """Three clipped, scheduled steps on reduced Mistral-NeMo-12B, each
    from the reference's gradients at the reference's parameters (the
    first step moves each weight by about +-lr: a gradient near zero
    whose sign differed between the packages would move it by 2 lr)."""
    jcfg, pcfg = _reduced("mistral-nemo-12b")
    sched = dict(base_lr=1e-3, warmup=2, total=6)
    jopt = j_adamw.AdamW(lr=j_adamw.cosine_schedule(**sched))
    popt = p_adamw.AdamW(lr=p_adamw.cosine_schedule(**sched))
    jp = j_lm.init_params(jcfg, jax.random.key(1))
    js = jopt.init(jp)
    pp = params_from_numpy(_np(jp), pcfg, device="cpu")
    ps = popt.init(pp)
    for step in range(3):
        batch = j_make_batch(jcfg, 2, 16, seed=10 + step)
        grads = jax.grad(lambda p: j_lm.loss_fn(
            p, jcfg, batch, dtype=jnp.float32)[0])(jp)
        if step == 0:
            assert float(j_adamw.global_norm(grads)) > 1.0   # clipped
        jp, js = jopt.update(grads, js, jp)
        pg = params_from_numpy(_np(grads), pcfg, device="cpu")
        pp, ps = popt.update(pg, ps, pp)
        assert int(ps.count) == int(js.count) == step + 1
        got = adamw_state_to_numpy(ps)
        for what, a, b in (("params", params_to_numpy(pp), jp),
                           ("m", got.m, js.m), ("v", got.v, js.v)):
            for (key, x), (_, y) in zip(_leaves_with_keys(a),
                                        _leaves_with_keys(_np(b))):
                np.testing.assert_allclose(x, y, rtol=ADAM_RTOL,
                                           atol=ADAM_RTOL * np.abs(y).max(),
                                           err_msg=f"{what}/{key}/{step}")


def test_adamw_decays_what_the_reference_decays():
    """The reference decays leaves of ndim >= 2 in its stacked layout: a
    layer's norm (L, D) yes, ``final_norm`` (D,) no."""
    _, pcfg = _reduced("zamba2-7b")
    p = p_lm.init_params(pcfg, device="cpu")
    decays = dict(zip((n for n, _ in named_leaves(p)), p_adamw._decays(p)))
    assert decays["layers.0.0.ln1"] and decays["tail.0.ln1"]
    assert decays["layers.0.0.ssm.w_z"]
    assert not decays["final_norm"] and not decays["shared_attn.ln1"]
    assert stacked_axes(pcfg)["layers"] == 2


def test_master_weights_match_reference():
    """bfloat16 parameters with float32 masters, ten steps from the same
    bfloat16 gradients, as ``tests/test_invariants.py`` drives the
    reference: the masters within 2e-6, the bfloat16 view bit for bit
    where the masters round alike."""
    rng = np.random.default_rng(0)
    w32 = rng.standard_normal((16, 16)).astype(np.float32)
    g = (rng.standard_normal((16, 16)) * 0.1).astype(np.float32)
    jg = {"w": jnp.asarray(g).astype(jnp.bfloat16)}
    jopt = j_adamw.AdamW(lr=1e-2, clip_norm=None, master_weights=True)
    popt = p_adamw.AdamW(lr=1e-2, clip_norm=None, master_weights=True)
    jp = {"w": jnp.asarray(w32).astype(jnp.bfloat16)}
    js = jopt.init(jp)
    pp = {"w": torch.from_numpy(w32).to(torch.bfloat16)}
    ps = popt.init(pp)
    for _ in range(10):
        jp, js = jopt.update(jg, js, jp)
        pp, ps = popt.update({"w": torch.from_numpy(g).to(torch.bfloat16)},
                             ps, pp)
    master = ps.master["w"].numpy()
    want = np.asarray(js.master["w"])
    np.testing.assert_allclose(master, want, rtol=ADAM_RTOL, atol=1e-7)
    same = master == want
    np.testing.assert_array_equal(
        pp["w"].float().numpy()[same],
        np.asarray(jp["w"].astype(jnp.float32))[same])


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_compression_matches_reference(method):
    rng = np.random.default_rng(4)
    tree = {"a": (rng.standard_normal((9, 13)) * 3).astype(np.float32),
            "b": {"c": rng.standard_normal(40).astype(np.float32),
                  "z": np.zeros(5, np.float32)}}
    res = {"a": rng.standard_normal((9, 13)).astype(np.float32) * 0.01,
           "b": {"c": rng.standard_normal(40).astype(np.float32) * 0.01,
                 "z": np.zeros(5, np.float32)}}

    def port(t):
        return jax.tree.map(torch.from_numpy, t)

    def back(t):
        return jax.tree.map(lambda x: x.numpy(), t)
    for got, want in (
            (back(p_comp.compress_decompress(port(tree), method)),
             j_comp.compress_decompress(tree, method)),
            (back(p_comp.compress_in_place(port(
                jax.tree.map(np.copy, tree)), method)),
             j_comp.compress_decompress(tree, method)),
            (back(p_comp.compress_with_feedback(port(tree), port(res),
                                                method)),
             j_comp.compress_with_feedback(tree, res, method)),
            (back(p_comp.init_residual(port(tree))),
             j_comp.init_residual(tree))):
        for (k, a), (_, b) in zip(_leaves_with_keys(got),
                                  _leaves_with_keys(_np(want))):
            np.testing.assert_array_equal(a, b, err_msg=k)


# --------------------------------------------------------------------------
# the data pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mistral-nemo-12b", "qwen2-vl-72b",
                                  "seamless-m4t-large-v2"])
def test_pipeline_batches_are_the_references(name):
    jcfg, pcfg = _reduced(name)
    kw = dict(global_batch=4, seq=16, num_hosts=2, host_index=1, seed=9)
    jpipe, ppipe = JPipeline(jcfg, **kw), PPipeline(pcfg, device="cpu", **kw)
    it = ppipe.iterate(start_step=2, prefetch=2)
    for step in (2, 3, 4):
        want = jpipe.batch(step)
        for got in (ppipe.batch(step), next(it)):
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert got[k].device.type == "cpu"
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                              err_msg=f"{k}@{step}")
                assert got[k].numpy().dtype == np.asarray(v).dtype
    it.close()
    with pytest.raises(ValueError, match="split"):
        PPipeline(pcfg, global_batch=3, seq=4, num_hosts=2, device="cpu")


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _trained_pair():
    """Reduced DeepSeek-7B after one reference step (non-zero moments):
    the reference's (params, state) and the port's, carried."""
    jcfg, pcfg = _reduced("deepseek-7b")
    opt = j_adamw.AdamW(lr=1e-3)
    jp = j_lm.init_params(jcfg, jax.random.key(0))
    grads = jax.grad(lambda p: j_lm.loss_fn(
        p, jcfg, j_make_batch(jcfg, 2, 8, seed=1), dtype=jnp.float32)[0])(jp)
    jp, js = opt.update(grads, opt.init(jp), jp)
    jp, js = _np(jp), _np(js)
    pp = params_from_numpy(jp, pcfg, device="cpu")
    ps = adamw_state_from_numpy(js, pcfg, device="cpu")
    return (jp, js), (pp, ps)


def _assert_trees_equal(got, want):
    g, w = _leaves_with_keys(got), _leaves_with_keys(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(a, b, err_msg=k)
        assert a.dtype == b.dtype, k


def test_port_checkpoint_restores_in_reference(tmp_path):
    (jp, js), (pp, ps) = _trained_pair()
    p_ckpt.save(tmp_path, 3, (pp, ps), extra={"who": "port"})
    assert p_ckpt.latest_step(tmp_path) == j_ckpt.latest_step(tmp_path) == 3
    template = jax.tree.map(jnp.zeros_like, (jp, js))
    got = j_ckpt.restore(tmp_path, template, step=3)
    _assert_trees_equal(_np(got), (jp, js))
    meta = j_ckpt.checkpoint_meta(tmp_path, 3)
    assert meta["extra"] == {"who": "port"}
    assert meta["keys"] == sorted(j_ckpt._flatten((jp, js)))


def test_reference_checkpoint_restores_in_port(tmp_path):
    (jp, js), (pp, ps) = _trained_pair()
    j_ckpt.save(tmp_path, 5, (jp, js))
    template = (p_lm.init_params(pp.cfg, seed=7, device="cpu"),
                p_adamw.AdamW().init(pp))
    rp, rs = p_ckpt.restore(tmp_path, template)
    assert isinstance(rp, p_lm.LM) and rs.count.dtype == torch.int32
    _assert_trees_equal((params_to_numpy(rp), adamw_state_to_numpy(rs)),
                        (jp, js))


def test_checkpoint_falls_back_past_a_corrupt_step(tmp_path):
    tree = {"a": torch.arange(8.0), "b": {"c": torch.ones((3, 3))}}
    p_ckpt.save(tmp_path, 1, tree)
    p_ckpt.save(tmp_path, 2, {"a": torch.arange(8.0) * 2, "b": tree["b"]})
    (tmp_path / "step_00000002" / "arrays.npz").write_bytes(b"truncated")
    assert not list(tmp_path.glob("*.tmp"))
    got = p_ckpt.restore(tmp_path, tree)
    assert torch.equal(got["a"], torch.arange(8.0))
    with pytest.raises(Exception):
        p_ckpt.restore(tmp_path, tree, step=2)
    (tmp_path / "step_00000001" / "manifest.json").unlink()
    (tmp_path / "step_00000001" / "arrays.npz").write_bytes(b"garbage")
    with pytest.raises(FileNotFoundError, match="corrupt"):
        p_ckpt.restore(tmp_path, tree)


def test_async_checkpointer_and_prune(tmp_path):
    tree = {"w": torch.full((4, 4), 3.0)}
    w = p_ckpt.AsyncCheckpointer(tmp_path)
    w.save(1, tree)
    w.save(2, {"w": tree["w"] * 2})        # waits for save 1
    tree["w"].zero_()                      # the snapshot was taken
    w.wait()
    assert p_ckpt.latest_step(tmp_path) == 2
    assert float(p_ckpt.restore(tmp_path, tree)["w"][0, 0]) == 6.0
    for s in (3, 4, 5):
        p_ckpt.save(tmp_path, s, tree)
    p_ckpt.prune_old(tmp_path, keep=2)
    assert sorted(int(p.name.split("_")[-1])
                  for p in tmp_path.glob("step_*")) == [4, 5]
    blocked = tmp_path / "a_file"
    blocked.write_text("not a directory")
    bad = p_ckpt.AsyncCheckpointer(blocked)
    bad.save(1, tree)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                             # the error is raised once


def test_decode_cache_checkpoint_roundtrip(tmp_path):
    """A decode interrupted mid-generation resumes bit-exactly, and the
    reference restores the port's cache checkpoint (float and int8)."""
    _, pcfg = _reduced("deepseek-7b")
    kw = dict(max_batch=2, prompt_len=4, max_gen=4, dtype=torch.float32,
              device="cpu")
    eng = PEngine(pcfg, seed=0, **kw)
    batch = eng.make_prompt_batch(seed=1)
    logits, caches = eng.prefill(batch)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    lg, caches = eng.decode_step(tok, caches, 4)
    tok = torch.argmax(lg[:, 0], dim=-1)[:, None]
    p_ckpt.save(tmp_path, 1, eng.cache_state(caches))
    eng2 = PEngine(pcfg, params=eng.params, **kw)
    template = {g: {n: torch.zeros_like(c) for n, c in grp.items()}
                for g, grp in caches.items()}
    caches2 = eng2.load_cache_state(template,
                                    p_ckpt.restore(tmp_path, template,
                                                   step=1))
    lg1, _ = eng.decode_step(tok, caches, 5)
    lg2, _ = eng2.decode_step(tok, caches2, 5)
    assert torch.equal(lg1, lg2)
    q8 = p_lm.init_caches(pcfg, 2, 8, dtype=torch.int8, device="cpu")
    q8["attn"]["k"].random_(-127, 127)
    q8["attn"]["k_scale"].uniform_()
    p_ckpt.save(tmp_path, 2, q8)
    want = jax.tree.map(lambda t: jnp.zeros(t.shape, str(t.dtype).split(
        ".")[-1]), q8)
    got = _np(j_ckpt.restore(tmp_path, want, step=2))
    for name, t in q8["attn"].items():
        np.testing.assert_array_equal(got["attn"][name], t.numpy())
    back = p_ckpt.restore(tmp_path, q8, step=2)
    assert back["attn"]["k"].dtype == torch.int8
    assert torch.equal(back["attn"]["k"], q8["attn"]["k"])


# --------------------------------------------------------------------------
# the training loop
# --------------------------------------------------------------------------

def _drill_setup():
    _, cfg = _reduced("deepseek-7b")
    opt = p_adamw.AdamW(lr=1e-3, clip_norm=1.0)
    pipe = PPipeline(cfg, global_batch=4, seq=32, device="cpu")

    def init_state():
        params = p_lm.init_params(cfg, seed=0, device="cpu")
        return params, opt.init(params)
    step_fn = p_steps.make_train_step(cfg, opt, dtype=torch.float32)
    return init_state, step_fn, pipe


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_restart_is_bit_exact(tmp_path):
    """Ten steps straight, against a crash at step 7 and a resume from
    the checkpoint of step 6: the parameters and moments bit for bit."""
    init_state, step_fn, pipe = _drill_setup()
    lc = TrainLoopConfig(total_steps=10, ckpt_every=3, log_every=100,
                         ckpt_dir=str(tmp_path / "a"), async_ckpt=False)
    p_straight, o_straight, _ = run(lc, init_state=init_state,
                                    step_fn=step_fn, batch_fn=pipe.batch,
                                    log=lambda *_: None)
    lc2 = dataclasses.replace(lc, ckpt_dir=str(tmp_path / "b"),
                              async_ckpt=True)
    with pytest.raises(RuntimeError, match="injected failure"):
        run(lc2, init_state=init_state, step_fn=step_fn,
            batch_fn=pipe.batch, injector=FailureInjector(fail_at_step=7),
            log=lambda *_: None)
    assert p_ckpt.latest_step(tmp_path / "b") == 6
    logs = []
    p_resumed, o_resumed, metrics = run(
        lc2, init_state=init_state, step_fn=step_fn, batch_fn=pipe.batch,
        log=logs.append)
    assert logs == ["[resume] from step 6"]
    assert _equal_trees(p_straight, p_resumed)
    assert _equal_trees(o_straight.m, o_resumed.m)
    assert _equal_trees(o_straight.v, o_resumed.v)
    assert int(o_resumed.count) == 10 and bool(torch.isfinite(
        metrics["loss"]))


def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=2.0, warmup=2)
    for step, dt in enumerate([0.1, 0.1, 0.1, 0.1, 0.5, 0.1]):
        wd.observe(step, dt)
    assert len(wd.flagged) == 1
    assert wd.flagged[0][0] == 4
    assert wd.ewma < 0.2


def test_launch_train_runs_on_the_cpu(tmp_path, capsys):
    out = io.StringIO()
    with redirect_stdout(out):
        p_train.main(["--arch", "deepseek-7b", "--reduced", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    assert "done: loss=" in out.getvalue()
    assert p_ckpt.latest_step(tmp_path) == 2
    # a mesh names its ranks: --mesh and --devices must agree
    for argv, msg in ((["--mesh", "2x1"], "needs --devices 2"),
                      (["--devices", "8"], "not --devices 8"),
                      (["--mesh", "3x1", "--devices", "3"],
                       "does not split")):
        with pytest.raises(SystemExit):
            p_train.main(["--arch", "deepseek-7b", "--reduced",
                          "--device", "cpu", *argv])
        assert msg in capsys.readouterr().err


# --------------------------------------------------------------------------
# cells and steps
# --------------------------------------------------------------------------

def _stacked_shapes(p, prefix=""):
    """The reference's leaf shapes of the port's LM (layers stacked)."""
    axes = stacked_axes(p.cfg)
    count, shapes = {}, {}
    for name, t in p.named_parameters():
        group, _, rest = name.partition(".")
        n = axes.get(group, 0) if rest else 0
        parts = rest.split(".", n) if rest else []
        idx, path = tuple(map(int, parts[:n])), parts[n:] or []
        key = "/".join([group, *path[0].split(".")] if path else [group])
        shapes[prefix + key] = tuple(t.shape)
        count[prefix + key] = tuple(max(c, i + 1) for c, i in zip(
            count.get(prefix + key, (0,) * n), idx))
    return {k: count[k] + shapes[k] for k in shapes}


def test_cells_and_specs_match_reference():
    assert [(a, dataclasses.asdict(c)) for a, c in p_cells.grid()] == \
        [(a, dataclasses.asdict(c)) for a, c in j_cells.grid()]
    for arch, cell in p_cells.grid():
        pcfg, jcfg = p_configs.get_arch(arch), j_configs.get_arch(arch)
        jcell = j_cells.CELLS[cell.name]
        assert p_cells.applicable(pcfg, cell) == \
            j_cells.applicable(jcfg, jcell)
        assert p_steps.model_flops(pcfg, cell) == \
            j_steps.model_flops(jcfg, jcell)
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in p_steps.input_specs(pcfg, cell).items()}
        want = {k: (v.shape, str(v.dtype))
                for k, v in j_steps.input_specs(jcfg, jcell).items()}
        assert got == want, (arch, cell.name)
        if cell.kind == "decode":
            tok, caches, idx = p_steps.decode_input_specs(pcfg, cell)
            jtok, jcaches, jidx = j_steps.decode_input_specs(jcfg, jcell)
            assert tuple(tok.shape) == jtok.shape and idx.shape == ()
            got = {k: tuple(v.shape) for k, v in _leaves_meta(caches)}
            want = {k: v.shape for k, v in _leaves_with_keys_abstract(
                jcaches)}
            assert got == want, (arch, cell.name)


def _leaves_meta(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves_meta(v, f"{prefix}{k}/")
        else:
            assert v.device.type == "meta"
            yield f"{prefix}{k}", v


def _leaves_with_keys_abstract(tree):
    return [("/".join(str(k.key) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_state_matches_reference(name):
    pcfg, jcfg = p_configs.get_arch(name), j_configs.get_arch(name)
    params, state = p_steps.abstract_state(pcfg, p_adamw.AdamW())
    assert all(t.device.type == "meta" for t in params.parameters())
    want = {k: v.shape for k, v in _leaves_with_keys_abstract(
        j_lm.abstract_params(jcfg))}
    assert _stacked_shapes(params) == want
    assert _stacked_shapes(state.m) == want
    assert state.count.dtype == torch.int32 and state.master is None


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the training step's CUDA path "
                    "has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_train_step_remat_changes_no_value(card):
    """On the card, reduced Mistral-NeMo-12B's gradients with remat equal
    those without within 1e-6 + 1e-5 |b| (the embedding's backward
    accumulates with atomics), and a train step's loss is finite."""
    _, pcfg = _reduced("mistral-nemo-12b")
    p = p_lm.init_params(pcfg, seed=2, device=card)
    batch = PPipeline(pcfg, global_batch=2, seq=32, device=card).batch(0)
    grads = {}
    for remat in (True, False):
        (_, _), g = p_steps.make_value_and_grad(
            pcfg, dtype=torch.float32, remat=remat)(p, batch)
        grads[remat] = dict(named_leaves(g))
    for name, want in grads[False].items():
        torch.testing.assert_close(grads[True][name], want, rtol=1e-5,
                                   atol=1e-6)
    opt = p_adamw.AdamW()
    step = p_steps.make_train_step(pcfg, opt, dtype=torch.float32)
    p, state, metrics = step(p, opt.init(p), batch)
    assert bool(torch.isfinite(metrics["loss"])) and int(state.count) == 1
