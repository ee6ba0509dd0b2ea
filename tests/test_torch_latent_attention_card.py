"""MLA decode's latent attention (``models.attention.latent_decode``) on
the card, against the masked whole-cache einsums it replaced: the
DeepSeek-V2 cell's call, Lite's 16 heads, two tokens a step, ragged
kv_len with NaN past it, and a decode step of the engine that calls it
once a layer and issues no host synchronisation.  Every test here needs
the card and skips elsewhere; ``tests/test_torch_latent_attention.py``
holds the same function on the CPU.

Tolerances: float32 sums in another order over up to 32768 positions,
1e-5 + 1e-4 |b|; the products never read past kv_len, so NaN there
changes no bit.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.models import attention as p_attn  # noqa: E402

#: DeepSeek-V2's softmax scale with YaRN: (0.1 ln 40 + 1)^2 / sqrt(192).
SCALE = 0.13499


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: holds the card's cuBLAS "
                    "products at the cell's size (the CPU tests hold the "
                    "same function at small sizes)")
    return torch.device("cuda")


def _inputs(card, b, s, h, s_max, r=512, rd=64, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn(b, s, h, r, generator=gen, device=card),
            torch.randn(b, s, h, rd, generator=gen, device=card),
            torch.randn(b, s_max, r, generator=gen, device=card),
            torch.randn(b, s_max, rd, generator=gen, device=card))


def _masked_full(q_lat, q_rope, lat, kr, kv_len, scale):
    """The decode branch's arithmetic before: scores over the whole
    cache, the positions past kv_len masked to -1e30."""
    sc = (torch.einsum("bqhr,bkr->bhqk", q_lat, lat)
          + torch.einsum("bqhd,bkd->bhqk", q_rope, kr)).float() * scale
    valid = torch.arange(lat.shape[1], device=lat.device) < kv_len
    sc = torch.where(valid, sc, p_attn.NEG_INF)
    return torch.einsum("bhqk,bkr->bqhr", torch.softmax(sc, -1), lat)


def _held(args, kv_len):
    """Against the masked einsums; NaN written past kv_len changes no
    bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    got = p_attn.latent_decode(*args, kv_len, SCALE)
    want = _masked_full(*args, kv_len, SCALE)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    del want
    lat, kr = args[2], args[3]
    lat[:, kv_len:] = float("nan")
    kr[:, kv_len:] = float("nan")
    again = p_attn.latent_decode(*args, kv_len, SCALE)
    torch.cuda.synchronize()
    assert torch.isfinite(again).all()
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv_len", [(128, 28673), (128, 32768),
                                      (16, 28673)])
def test_card_latent_decode_at_the_cells_call(card, h, kv_len):
    """64 sequences, a cache of 32768 at latent 512 and rope 64: the
    cell's 128 heads at the window's first step and at a full cache, and
    Lite's 16 heads."""
    _held(_inputs(card, 64, 1, h, 32768), kv_len)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_len", [1, 31, 32, 33, 64])
@pytest.mark.parametrize("h,s", [(16, 1), (16, 2), (128, 1), (128, 2)])
def test_card_latent_decode_at_ragged_kv_len(card, h, s, kv_len):
    _held(_inputs(card, 3, s, h, 64, seed=kv_len), kv_len)


@pytest.mark.gpu
@pytest.mark.parametrize("r,rd,h", [(64, 16, 4), (32, 8, 4), (512, 64, 40)])
def test_card_latent_decode_at_other_widths(card, r, rd, h):
    """The reduced configs' widths, and 40 heads."""
    _held(_inputs(card, 2, 1, h, 80, r=r, rd=rd, seed=r), 69)


def _engine(card):
    from repro_torch.models.engine import DecodeEngine
    # every layer dense: the step's only MoE-free path to the latent cache
    cfg = dataclasses.replace(
        p_configs.reduced(p_configs.get_arch("deepseek-v2-lite-16b")),
        n_layers=3, first_dense_layers=3)
    return DecodeEngine(cfg, max_batch=2, prompt_len=6, max_gen=4,
                        dtype=torch.float32, device=card)


@pytest.mark.gpu
def test_card_decode_step_calls_it_once_a_layer_and_waits_for_nothing(
        card, monkeypatch):
    """A decode step of the reduced DeepSeek-V2-Lite (its layers dense)
    on the card runs ``latent_decode`` once a layer over the valid
    positions and issues no host synchronisation."""
    eng = _engine(card)
    logits, caches = eng.prefill(eng.make_prompt_batch(seed=2))
    tok = logits[:, -1].argmax(-1)[:, None]
    eng.decode_step(tok, caches, 6)                         # warm
    torch.cuda.synchronize()
    calls = []
    monkeypatch.setattr(p_attn, "latent_decode", _counted(calls))
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.decode_step(tok, caches, 7)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert calls == [8] * eng.cfg.n_layers


def _counted(calls):
    plain = p_attn.latent_decode

    def spy(q_lat, q_rope, latent, k_rope, kv_len, scale):
        calls.append(kv_len)
        return plain(q_lat, q_rope, latent, k_rope, kv_len, scale)
    return spy
