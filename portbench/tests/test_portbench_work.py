"""The roofline and mfu counts of one conv and one FC, worked by hand."""
import numpy as np
import pytest

from portbench._frozen.intervals import device_time, idle_gaps
from portbench._frozen.pruning import prune_balanced
from portbench.harness.context import Context
from portbench.harness.session import Call
from portbench.harness.trace import Trace
from portbench.harness.work import layer_work, wave_work
from portbench.reference.common import Layer
from portbench.tests.conftest import BENCH
from portbench.harness.manifest import load_module

PEAK, BW = 67e12, 3.35e12


def test_conv_3x3_counts():
    # 3x3, 256 -> 256 on 14x14, density 0.235: KB = 9 * 256 / 32 = 72,
    # S = round(72 * 0.235) = round(16.92) = 17 tiles a strip, 2 strips
    l = Layer("c", "conv", 256, 256, 3, 3, 1, h_in=14, w_in=14, h_out=14,
              w_out=14)
    w = layer_work(l, 0.235, vk=32, vn=128)
    kept = 17 * 32 * 256          # S tiles x vk rows x cout columns
    assert w.kernel == "vsconv"
    assert w.macs == kept * 14 * 14
    assert w.act_bytes == 4 * (256 * 196 + 256 * 196)
    assert w.weight_bytes == 4 * (kept + 2 * 17 + 256)
    rows = 32
    flops = 2 * kept * 196 * rows
    nbytes = 4 * (2 * 256 * 196 * rows) + 4 * (kept + 34 + 256)
    assert wave_work([w], rows, "vsconv", flops_peak=PEAK,
                     bytes_peak=BW) == pytest.approx(
        max(flops / PEAK, nbytes / BW), rel=1e-12)


def test_fc_with_a_remainder_strip_counts():
    # 2048 -> 1000: strips of 128, 8 of them (the last 104 real columns),
    # KB = 64, S = round(64 * 0.235) = 15
    l = Layer("fc", "fc", 2048, 1000, relu=False)
    w = layer_work(l, 0.235, vk=32, vn=128)
    kept = 15 * 32 * 1000
    assert w.kernel == "vsmm"
    assert w.macs == kept
    assert w.act_bytes == 4 * (2048 + 1000)
    assert w.weight_bytes == 4 * (kept + 8 * 15 + 1000)
    t = wave_work([w], 32, "vsmm", flops_peak=PEAK, bytes_peak=BW)
    # 32 rows: the weights dominate, memory-bound
    assert t == pytest.approx((4 * 32 * 3048 + w.weight_bytes) / BW)


def test_strided_1x1_reads_the_sampled_pixels_and_stem_is_dense():
    d = Layer("d", "conv", 256, 512, 1, 1, 2, h_in=56, w_in=56, h_out=28,
              w_out=28)
    w = layer_work(d, 0.235, vk=32, vn=128)
    assert w.kernel == "vsmm"
    assert w.act_bytes == 4 * (256 + 512) * 28 * 28
    stem = Layer("s", "conv", 3, 64, 7, 7, 2, h_in=224, w_in=224,
                 h_out=112, w_out=112)
    ws = layer_work(stem, 0.235, vk=32, vn=128)
    assert ws.macs == 7 * 7 * 3 * 64 * 112 * 112   # cin < vk: not pruned


def _ctx(spans, calls, works, window_s=1.0):
    busy, by_name = device_time(sorted(spans))
    tr = Trace(window_s, busy / 1e6, sorted(spans), by_name, [], [])
    return Context(calls, {}, tr, works, PEAK, BW, 32)


def test_mfu_and_roofline_by_hand():
    conv = layer_work(Layer("c", "conv", 256, 256, 3, 3, 1, h_in=14,
                            w_in=14, h_out=14, w_out=14), 0.235, vk=32,
                      vn=128)
    fc = layer_work(Layer("fc", "fc", 2048, 1000, relu=False), 0.235,
                    vk=32, vn=128)
    calls = [Call(0.0, 0.5, [32, 32], 64, True)]
    # two waves: each a conv launch (100 us) and a vsmm launch with its
    # second phase (10 + 5 us), plus a 20 us copy
    spans, t = [], 0.0
    for _ in range(2):
        spans += [(t, t + 100, "void vsconv_halo_kernel<4, 8, true>(gen::Conv)"),
                  (t + 100, t + 110, "void vsmm_kernel<8>(float const*)"),
                  (t + 110, t + 115, "vsmm_reduce_kernel(float const*)"),
                  (t + 115, t + 135, "Memcpy HtoD (Pinned -> Device)")]
        t += 1000
    ctx = _ctx(spans, calls, [conv, fc], window_s=0.5)
    bound_conv = 2 * wave_work([conv], 32, "vsconv", flops_peak=PEAK,
                               bytes_peak=BW)
    assert ctx.roofline("vsconv") == pytest.approx(
        100 * bound_conv / 200e-6)
    bound_mm = 2 * wave_work([fc], 32, "vsmm", flops_peak=PEAK,
                             bytes_peak=BW)
    assert ctx.roofline("vsmm") == pytest.approx(100 * bound_mm / 30e-6)
    mfu = load_module(BENCH / "metrics" / "mfu.py").read(ctx)
    assert mfu == pytest.approx(100 * 2 * (conv.macs + fc.macs) * 64
                                / (0.5 * PEAK))
    idle = load_module(BENCH / "metrics" / "idle_share.py").read(ctx)
    assert idle == pytest.approx(100 * (1 - 270e-6 / 0.5))
    glue = load_module(BENCH / "metrics" / "glue_ms_per_image.py").read(ctx)
    assert glue == pytest.approx(0.040 / 64)


def test_roofline_is_silent_where_launches_do_not_match_the_layers():
    conv = layer_work(Layer("c", "conv", 256, 256, 3, 3, 1, h_in=14,
                            w_in=14, h_out=14, w_out=14), 0.235, vk=32,
                      vn=128)
    calls = [Call(0.0, 0.5, [32, 32], 64, True)]
    spans = [(0, 100, "vsconv_halo_kernel")]   # one launch for two waves
    assert _ctx(spans, calls, [conv]).roofline("vsconv") is None
    assert _ctx(spans, calls, [conv]).roofline("vsmm") is None


def test_interval_union_and_gaps():
    spans = sorted([(0, 10, "a"), (5, 20, "b"), (30, 40, "c")])
    busy, by = device_time(spans)
    assert busy == 30 and by["b"] == (0.015, 1)
    assert idle_gaps(spans, 0, 50) == [(20, 30), (40, 50)]


def test_balanced_pruning_keeps_the_largest_tiles_of_each_strip():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8 * 32, 3 * 128)).astype(np.float32)
    wp, mask = prune_balanced(w, 0.25, 32, 128)
    assert (mask.sum(axis=0) == 2).all()
    norms = np.sqrt((w.reshape(8, 32, 3, 128) ** 2).sum(axis=(1, 3)))
    for j in range(3):
        kept = set(np.flatnonzero(mask[:, j]))
        assert kept == set(np.argsort(-norms[:, j])[:2])
    m = np.repeat(np.repeat(mask, 32, 0), 128, 1)
    np.testing.assert_array_equal(wp, w * m)
