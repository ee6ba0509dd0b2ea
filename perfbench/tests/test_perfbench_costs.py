"""The frozen bytes and operations, checked by hand."""
import math

import pytest

from perfbench.costs import bound_s, decode, kernels
from perfbench.harness import core

H100 = core.peaks_for("NVIDIA H100 80GB HBM3")


def test_scale_at_2_26_float32():
    assert kernels.scale(2**26, 4) == (536_870_912.0, 2.0**26)


def test_triad_and_stencils():
    assert kernels.triad(2**26, 4)[0] == 805_306_368
    assert kernels.stencil(5, 3, (8192, 8192), 4) == (536_870_912.0,
                                                      2 * 5 * 3 * 8192**2)
    assert kernels.stencil(7, 3, (512, 512, 512), 4)[0] == 1_073_741_824


def test_spmv_counts_the_block_ell_arrays_as_given():
    # 1024 block rows of 128 stored 8 x 128 blocks, their int32 column
    # ids, x (16384) and y (8192) in float32
    nbytes, flops = kernels.spmv_bell(1024, 128, 8, 128, 16384)
    assert nbytes == 131072 * (8 * 128 * 4 + 4) + (16384 + 8192) * 4
    assert flops == 2 * 131072 * 8 * 128


def test_flash_decode_counts_valid_positions():
    nbytes, flops = kernels.flash_decode(4, 8, 4, 128, 32768, 28672, 4)
    assert nbytes == (2 * 4 * 28672 * 8 * 128 + 2 * 4 * 8 * 4 * 128) * 4
    assert flops == 4 * 4 * 8 * 4 * 28672 * 128
    # kv_len <= 0 reads every position
    assert kernels.flash_decode(1, 1, 1, 16, 64, 0, 4)[0] == \
        (2 * 64 * 16 + 2 * 16) * 4


def test_the_stream_pass_is_4_43_gb_with_a_1_322_ms_bound():
    cfg = core.config("paper-stream-f32")
    total_b = total_f = 0.0
    for item in cfg["suite"]:
        fam = item["family"]
        if fam == "scale":
            b, f = kernels.scale(item["n"], 4)
        elif fam == "triad":
            b, f = kernels.triad(item["n"], 4)
        elif fam == "spmv":
            rows, cols = item["rows"], item["cols"]
            bm, bn = item["block"]
            b, f = kernels.spmv_bell(rows // bm, cols // bn, bm, bn, cols)
        elif fam == "stencil":
            pts = 1 + 2 * len(item["shape"]) * len(item["wing"])
            b, f = kernels.stencil(pts, item["steps"], item["shape"], 4)
        else:
            b, f = kernels.flash_decode(item["b"], item["kh"], item["g"],
                                        item["dh"], item["s"],
                                        item["kv_len"], 4)
        total_b += b
        total_f += f
    assert total_b == 4_429_938_688
    assert bound_s(total_b, total_f, H100) == pytest.approx(1.3224e-3,
                                                            rel=1e-4)


def test_a_mistral_decode_step_at_kv_len_28672():
    cfg = core.config("mistral-nemo-12b-pp4")
    b, kv = 16, 28672
    d, f, v, layers = 5120, 14336, 131072, 10
    q, kvd = 32 * 128, 8 * 128
    weights = layers * (d * q + 2 * d * kvd + q * d + 3 * d * f) + d * v
    expect_b = (weights + layers * 2 * b * kv * kvd + layers * 2 * b * kvd
                ) * 4 + b * v * 4
    expect_f = 2 * b * weights + layers * 4 * b * 32 * kv * 128
    nbytes, flops = decode.step(cfg, b, kv)
    assert nbytes == expect_b and flops == expect_f
    # ~13.6 GB of weights and head, ~37.6 GB of cache: ~15.3 ms at HBM
    assert math.isclose(nbytes, 51.2e9, rel_tol=0.01)
    assert bound_s(nbytes, flops, H100) == pytest.approx(nbytes / 3.35e12)
