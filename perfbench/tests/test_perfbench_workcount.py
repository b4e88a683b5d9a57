"""The frozen work counts against hand counts at small shapes."""

import math

import pytest

from perfbench import workcount as w


def test_edge_forward_by_hand():
    # B=1, N=2, k=1 (E=2), H=32, D=5, float32 stream, no dropout.
    # bytes: t and s 2*4*2*32 = 512; edge_attr 4*2*5 = 40; W_e 4*5*32 =
    # 640; gamma, beta 256; CSR 4*(2*2 + 3) = 28; out 4*2*32 = 256.
    n_bytes = 512 + 40 + 640 + 256 + 28 + 256
    flops = (13 + 10) * 2 * 32
    assert w.edge_fwd_s(1, 2, 2, 32, 4, False) == pytest.approx(
        max(n_bytes / 3.35e12, flops / 67e12), rel=1e-12)
    # bf16 stream halves t and s; dropout adds one operation a channel.
    assert w.edge_fwd_s(1, 2, 2, 32, 2, True) == pytest.approx(
        max((n_bytes - 256) / 3.35e12, (flops + 64) / 67e12), rel=1e-12)


def test_edge_backward_by_hand():
    # operands as the forward (without its output) 1,476 bytes, a second
    # CSR 28, g_out read and d_t, d_s written 2*32*(4 + 8) = 768, the
    # (D+2, H) parameter gradients 4*7*32 = 896.
    n_bytes = 1476 + 28 + 768 + 896
    flops = (30 + 20) * 2 * 32
    assert w.edge_bwd_s(1, 2, 2, 32, 4, False) == pytest.approx(
        max(n_bytes / 3.35e12, flops / 67e12), rel=1e-12)


def test_bound_at_the_production_shape():
    """Operations-bound at B=24, N=200, k=40, H=256: (13 + 10 + 1) x
    192,000 edges x 256 channels over 67 TFLOP/s."""
    t = w.edge_fwd_s(24, 200, 8000, 256, 2, True)
    assert t == pytest.approx(24 * 24 * 8000 * 256 / 67e12, rel=1e-12)


def test_forward_products_by_hand():
    # One graph, N=4, k=2, H=8, 1 layer, in 7, out 6, float32.
    n, k, h = 4, 2, 8
    mm = (2 * n * 7 * h + 2 * n * h * h          # encoder
          + 2 * n * h * h * 2 + 2 * n * h * h    # projections, edge out
          + 2 * n * 2 * h * h + 2 * n * h * h    # node MLP
          + 2 * n * h * h + 2 * n * h * (h // 2)  # decoder 0, 1
          + 2 * n * (h // 2) * 6)                # decoder out
    work = w.forward_work(1, n, k, h, 1, 7, 6, "float32", False)
    assert work.mm_f32 == mm and work.mm_bf16 == 0
    bf = w.forward_work(1, n, k, h, 1, 7, 6, "bfloat16", False)
    assert bf.mm_f32 == 2 * n * (h // 2) * 6
    assert bf.mm_bf16 == mm - bf.mm_f32
    assert bf.other == work.other


def test_backward_doubles_the_products():
    f = w.forward_work(2, 10, 3, 16, 2, 7, 6, "bfloat16", True)
    b = w.backward_work(2, 10, 3, 16, 2, 7, 6, "bfloat16", True)
    assert b.mm_bf16 == 2 * f.mm_bf16 and b.mm_f32 == 2 * f.mm_f32
    stream_f = (13 + 10 + 1) * 2 * 30 * 16 * 2
    stream_b = (30 + 20 + 1) * 2 * 30 * 16 * 2
    assert b.other == 2 * (f.other - stream_f) + stream_b


def test_least_time_sums_each_kind_at_its_rate():
    work = w.Work(mm_bf16=989e12, mm_f32=67e12, other=134e12)
    assert work.least_s() == pytest.approx(4.0)
    assert (work * 0.5).least_s() == pytest.approx(2.0)


def test_step_counts_are_positive_and_grow_with_n():
    small = w.train_step_work(24, 200, 40, 256, 6, 7, 6, 2_550_150,
                              "bfloat16").least_s()
    large = w.train_step_work(24, 5000, 40, 256, 6, 7, 6, 2_550_150,
                              "bfloat16").least_s()
    assert 0 < small < large
    assert math.isclose(large / small, 25, rel_tol=0.05)
