"""bfloat16 checkpoint leaves: the port writes and reads them as the
reference writes them.

* The port's ``arrays.npz`` members are byte for byte the reference's for
  the same bfloat16 (and float32) values: raw 2-byte ``<V2`` records.
* A file the reference wrote restores in the port bit for bit (the
  reference's own restore cannot read it back: ``astype`` has no cast
  from void).
* The port's own round trip is bit-exact, the async writer's too, and a
  bfloat16 leaf restores into a float32 template as its float32 values.
"""
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.runtime import checkpoint as j_ckpt  # noqa: E402

from repro_torch.runtime import checkpoint as p_ckpt  # noqa: E402

SHAPES = [(5,), (3, 4), (2, 3, 8)]


def _values(shape, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(shape).astype(np.float32) * 100
    # the edges of bfloat16: signed zero, subnormal, inf, largest finite
    flat = vals.reshape(-1)
    flat[:4] = [-0.0, 1e-40, np.inf, 3.38e38][:flat.size]
    return vals


def _trees(vals):
    jt = {"w": jnp.asarray(vals, dtype=jnp.bfloat16),
          "f": jnp.asarray(vals),
          "nested": {"b": jnp.asarray(vals[..., :1], dtype=jnp.bfloat16)}}
    t = torch.from_numpy(vals)
    pt = {"w": t.to(torch.bfloat16), "f": t.clone(),
          "nested": {"b": t[..., :1].to(torch.bfloat16)}}
    return jt, pt


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("shape", SHAPES)
def test_port_bytes_equal_reference_bytes(tmp_path, shape):
    jt, pt = _trees(_values(shape))
    j_ckpt.save(tmp_path / "j", 1, jt)
    p_ckpt.save(tmp_path / "p", 1, pt)
    want = _members(tmp_path / "j" / "step_00000001" / "arrays.npz")
    got = _members(tmp_path / "p" / "step_00000001" / "arrays.npz")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert b"'descr': '<V2'" in got["w.npy"]


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_file_restores_bit_for_bit(tmp_path, shape):
    vals = _values(shape)
    jt, pt = _trees(vals)
    j_ckpt.save(tmp_path, 3, jt)
    template = {"w": torch.zeros(shape, dtype=torch.bfloat16),
                "f": torch.zeros(shape),
                "nested": {"b": torch.zeros(shape[:-1] + (1,),
                                            dtype=torch.bfloat16)}}
    got = p_ckpt.restore(tmp_path, template, step=3)
    for key in ("w", "f"):
        assert got[key].dtype == pt[key].dtype
        assert torch.equal(got[key].view(torch.int16)
                           if key == "w" else got[key],
                           pt[key].view(torch.int16)
                           if key == "w" else pt[key])
    assert torch.equal(got["nested"]["b"].view(torch.int16),
                       pt["nested"]["b"].view(torch.int16))
    # the reference's own restore cannot read its bfloat16 leaf back
    with pytest.raises((ValueError, TypeError)):
        j_ckpt.restore(tmp_path, jt, step=3)


@pytest.mark.parametrize("shape", SHAPES)
def test_port_round_trip_is_bit_exact(tmp_path, shape):
    _, pt = _trees(_values(shape, seed=1))
    p_ckpt.save(tmp_path, 7, pt)
    template = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor)
                    else {"b": torch.zeros_like(v["b"])})
                for k, v in pt.items()}
    got = p_ckpt.restore(tmp_path, template)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), pt["w"].view(torch.int16))
    assert torch.equal(got["f"], pt["f"])
    assert torch.equal(got["nested"]["b"].view(torch.int16),
                       pt["nested"]["b"].view(torch.int16))


def test_async_writer_round_trip_and_float32_template(tmp_path):
    _, pt = _trees(_values((4, 4), seed=2))
    writer = p_ckpt.AsyncCheckpointer(tmp_path)
    writer.save(1, {"w": pt["w"]})
    writer.wait()
    got = p_ckpt.restore(tmp_path, {"w": torch.zeros(4, 4,
                                                     dtype=torch.bfloat16)})
    assert torch.equal(got["w"].view(torch.int16), pt["w"].view(torch.int16))
    # a float32 template takes the bfloat16 values, widened exactly
    wide = p_ckpt.restore(tmp_path, {"w": torch.zeros(4, 4)})
    assert wide["w"].dtype == torch.float32
    assert torch.equal(wide["w"], pt["w"].float())
