"""The references agree with the port's plain path at a small size on
the CPU, within the committed limits, and their TF32 control does not."""
import pytest
import torch

from perfbench.harness import core, inputs
from perfbench.reference import dense_lm, stream, tf32
from perfbench.tests import tiny


def _port_call(item, inp, engine):
    from repro_torch.kernels import registry
    from repro_torch.kernels.spmv.ops import dense_to_bell
    from repro_torch.kernels.stencil.defs import suite
    fam = item["family"]
    op = registry.get(fam)
    if fam == "scale":
        args, kw = (inp["b"], inp["q"]), {}
    elif fam == "triad":
        args, kw = (inp["b"], inp["c"], inp["q"]), {}
    elif fam == "spmv":
        args, kw = (dense_to_bell(inp["a"], *item["block"]), inp["x"]), {}
    elif fam == "stencil":
        args, kw = (inp["u"], suite()[item["name"]]), {"steps": item["steps"]}
    else:
        args, kw = (inp["q"], inp["k"], inp["v"], inp["kv_len"]), {}
    return op(*args, engine=engine, backend="plain", **kw)


@pytest.mark.parametrize("engine", ["vector", "matrix"])
@pytest.mark.parametrize("index", range(len(tiny.STREAM_SUITE)))
def test_stream_reference_matches_the_port_and_not_its_control(engine,
                                                               index):
    item = tiny.STREAM_SUITE[index]
    limit = core.workload(f"paper-stream-f32.{engine}")["limits"][
        f"{item.get('name', item['family'])}_err"]
    inp = inputs.stream_item(torch, item, index, 5, "cpu")
    ref, den = stream.compute(torch, item, inp, "float64")
    out = _port_call(item, inp, engine)
    assert stream.error(torch, out, ref, den) < limit / 3
    ctl, _ = stream.compute(torch, item, inp, "tf32")
    assert stream.error(torch, ctl, ref, den) > limit * 3


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0, 1.0 + 2**-12])
    assert tf32(torch, x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0,
                                       1.0]


def test_rmsnorm_and_rope_match_the_port():
    from repro_torch.models.layers import apply_rope, rmsnorm
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 64, generator=g)
    w = 1 + 0.1 * torch.randn(64, generator=g)
    assert torch.allclose(dense_lm.rmsnorm(torch, x, w, 1e-5),
                          rmsnorm(w, x, 1e-5), rtol=1e-6, atol=1e-6)
    q = torch.randn(2, 5, 4, 16, generator=g)
    pos = torch.arange(28670, 28675)
    ours = dense_lm.rope(torch, q, pos, 1e6)
    port = apply_rope(q, pos[None].expand(2, 5), 1e6)
    assert torch.allclose(ours, port, rtol=1e-5, atol=1e-5)


def test_attend_matches_a_dense_softmax():
    g = torch.Generator().manual_seed(1)
    b, s, t, kh, gq, dh = 2, 7, 5, 2, 3, 8
    q = torch.randn(b, t, kh * gq, dh, generator=g)
    hk, hv = (torch.randn(b, s, kh, dh, generator=g) for _ in range(2))
    k, v = (torch.randn(b, t, kh, dh, generator=g) for _ in range(2))
    out = dense_lm.attend(torch, q, hk, hv, k, v, "float32", q_block=2)
    keys = torch.cat([hk, k], 1).repeat_interleave(gq, dim=2)
    vals = torch.cat([hv, v], 1).repeat_interleave(gq, dim=2)
    sc = torch.einsum("bthd,bshd->bhts", q, keys) / dh**0.5
    mask = torch.arange(s + t)[None, :] > (s + torch.arange(t))[:, None]
    p = torch.softmax(sc.masked_fill(mask, float("-inf")), -1)
    want = torch.einsum("bhts,bshd->bthd", p, vals).reshape(b, t, -1)
    assert torch.allclose(out, want, rtol=1e-5, atol=1e-5)
