"""The port's PE-array cycle model and traffic model
(`repro_torch.core.accel_model`) against the reference's
(`repro.core.accel_model`), on the CPU.

The same numpy inputs, made from a seed, go through both: every field of
`conv_layer_cycles`' `CycleReport` and of `conv_layer_traffic`'s
`TrafficReport` must be equal, over strides 1 and 2, groups, depthwise,
dilation and both block maps; both impls and both dtypes for the traffic.
Over a whole net (ResNet-18 and MobileNetV1 at 32 px, seeded numpy
weights pruned by the reference's `sparsify` and carried into the port by
`params.py`), each side's
`collect_conv_traffic` feeds its own `network_cycle_reports` and
`network_traffic_reports`: every field equal.  Cycle counts are integers,
so equality is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from _torch_resnet_parity import weights
from repro.core import accel_model as R
from repro.models import graph as jg
from repro_torch.configs import get_config, list_cnn_archs
from repro_torch.core import accel_model as T
from repro_torch.models import graph as tg
from repro_torch.params import params_from_numpy, sparse_from_numpy

PES = {"4x14x3": (T.PE_4_14_3, R.PE_4_14_3), "8x7x3": (T.PE_8_7_3, R.PE_8_7_3),
       "width": (T.PEConfig(4, 7, block_map="width"),
                 R.PEConfig(4, 7, block_map="width"))}

# (H, W, Cin, kh, kw, Cout, stride, groups, dilation)
CYCLE_CASES = {
    "3x3_s1": (14, 14, 16, 3, 3, 24, 1, 1, 1),
    "3x3_s2_odd": (15, 13, 8, 3, 3, 12, 2, 1, 1),
    "7x7_s2_stem": (32, 32, 3, 7, 7, 16, 2, 1, 1),
    "1x1_s2": (16, 16, 32, 1, 1, 16, 2, 1, 1),
    "grouped": (12, 12, 16, 3, 3, 16, 1, 4, 1),
    "depthwise_s2": (14, 14, 8, 3, 3, 8, 2, 8, 1),
    "dilated": (17, 17, 6, 3, 3, 10, 1, 1, 2),
    "5x3_dilated_s2": (20, 18, 4, 5, 3, 6, 2, 2, 3),
}


def _cycle_inputs(case, seed=0):
    h, w, cin, kh, kw, cout, stride, groups, dil = CYCLE_CASES[case]
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((h, w, cin)), 0).astype(np.float32)
    x[:, rng.random(w) < 0.2] = 0.0           # whole zero input columns
    wt = rng.standard_normal((kh, kw, cin // groups, cout)).astype(np.float32)
    wt *= rng.random((1, kw, cin // groups, cout)) < 0.5   # pruned columns
    return x, wt, dict(stride=stride, groups=groups, dilation=dil)


@pytest.mark.parametrize("pe", sorted(PES))
@pytest.mark.parametrize("case", sorted(CYCLE_CASES))
def test_conv_layer_cycles_matches_reference(case, pe):
    x, w, kw = _cycle_inputs(case)
    tpe, rpe = PES[pe]
    got = T.conv_layer_cycles(x, w, tpe, **kw)
    want = R.conv_layer_cycles(x, w, rpe, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.speedup, got.frac_ideal_vector_exploited,
            got.frac_ideal_fine_exploited) == (
        want.speedup, want.frac_ideal_vector_exploited,
        want.frac_ideal_fine_exploited)
    # a torch tensor gives the same counts as its numpy array
    assert T.conv_layer_cycles(torch.from_numpy(x), torch.from_numpy(w), tpe,
                               **kw) == got


def test_table1_gives_15_and_8_cycles():
    r = T.table1_example()
    assert (r.dense, r.vscnn) == (15, 8)
    assert dataclasses.asdict(r) == dataclasses.asdict(R.table1_example())
    assert T.PE_4_14_3.n_pe == T.PE_8_7_3.n_pe == 168
    agg = T.aggregate([r, r])
    assert (agg.dense, agg.vscnn) == (30, 16)


# (x_shape, kh, kw, stride, groups, dilation, cout, s_steps, vk, vn, residual)
TRAFFIC_CASES = {
    "3x3_s1": ((2, 14, 14, 64), 3, 3, 1, 1, 1, 128, 9, 32, 128, False),
    "3x3_s2_res": ((1, 15, 15, 64), 3, 3, 2, 1, 1, 128, 7, 32, 64, True),
    "resident": ((2, 3, 3, 128), 3, 3, 1, 1, 1, 256, 20, 32, 128, False),
    "stem_7x7": ((1, 32, 32, 8), 7, 7, 2, 1, 1, 64, 49, 8, 64, False),
    "grouped": ((1, 12, 12, 128), 3, 3, 1, 2, 1, 128, 5, 32, 64, True),
    "depthwise": ((1, 14, 14, 256), 3, 3, 2, 256, 1, 256, 4, 1, 128, False),
    "dilated": ((1, 16, 16, 32), 3, 3, 1, 1, 2, 64, 4, 32, 64, False),
    "1x1_s2_res": ((2, 8, 8, 64), 1, 1, 2, 1, 1, 128, 1, 32, 128, True),
}


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("impl", ["halo", "stack"])
@pytest.mark.parametrize("case", sorted(TRAFFIC_CASES))
def test_conv_layer_traffic_matches_reference(case, impl, dtype):
    shape, kh, kw, s, g, d, cout, steps, vk, vn, res = TRAFFIC_CASES[case]
    items = ({} if dtype == "f32"
             else dict(itemsize=1, w_itemsize=1, out_itemsize=4))
    args = dict(kh=kh, kw=kw, stride=s, groups=g, dilation=d, cout=cout,
                s_steps=steps, vk=vk, vn=vn, impl=impl, residual=res,
                **items)
    got = T.conv_layer_traffic(shape, **args)
    want = R.conv_layer_traffic(shape, **args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.kernel_bytes, got.bytes_accessed,
            got.arithmetic_intensity) == (want.kernel_bytes,
                                          want.bytes_accessed,
                                          want.arithmetic_intensity)


def test_predicted_layer_time_matches_reference():
    tr_t = T.conv_layer_traffic((1, 14, 14, 64), kh=3, kw=3, cout=128,
                                s_steps=9, vk=32, vn=128)
    tr_r = R.conv_layer_traffic((1, 14, 14, 64), kh=3, kw=3, cout=128,
                                s_steps=9, vk=32, vn=128)
    from repro.core.calibration import CalibConstants as RC
    from repro_torch.core.calibration import CalibConstants as TC
    consts = dict(backend="cpu", cycle_time_ns=1.5, per_tap_overhead=3.0,
                  vsmm_flush_cycles=7.0, dma_overlap=0.25,
                  fixed_overhead_us=4.0, hbm_gbps=20.0)
    geo = dict(nb=1, s_steps=9, blocks=2, vk=32, vn=128)
    assert T.predicted_layer_time_s(tr_t, constants=TC(**consts), **geo) == \
        R.predicted_layer_time_s(tr_r, constants=RC(**consts), **geo)


def test_configs_carry_the_pe_configs_and_paper_points():
    from repro.configs import vscnn_vgg16 as jcfg
    for arch in list_cnn_archs():
        cfg = get_config(arch)
        assert cfg.pe_configs == (T.PE_4_14_3, T.PE_8_7_3)
        assert cfg.reduce().pe_configs == cfg.pe_configs
    vgg = get_config("vscnn-vgg16")
    for f in ("paper_speedup", "paper_frac_ideal_vector",
              "paper_frac_ideal_fine"):
        assert getattr(vgg, f) == getattr(jcfg.CONFIG, f), f
    assert [dataclasses.asdict(p) for p in vgg.pe_configs] == [
        dataclasses.asdict(p) for p in jcfg.CONFIG.pe_configs]


def _ref_traffic(net, params, x):
    """The reference's `collect_conv_traffic` under one jit (its eager
    forward takes many seconds): the recorded inputs and weights as
    numpy, the static fields as the record holds them."""
    static = []

    def run(p, xx):
        rec = jg.collect_conv_traffic(net, p, xx)
        static[:] = [(r[0], r[3], r[4], r[5]) for r in rec]
        return [(r[1], r[2]) for r in rec]

    arrays = jax.jit(run)(params, x)
    return [(name, np.asarray(a), np.asarray(w), s, g, d)
            for (name, s, g, d), (a, w) in zip(static, arrays)]


NETS = {"resnet18": (jg.build_resnet18, tg.build_resnet18, 0.5),
        "mobilenet_v1": (jg.build_mobilenet_v1, tg.build_mobilenet_v1, 0.5)}


@pytest.fixture(scope="module", params=sorted(NETS))
def traffic(request):
    """(name, reference traffic + sparse, port traffic + sparse, port net,
    port pruned tree, input) for one net at 32 px, batch 2."""
    jb, tb, density = NETS[request.param]
    jnet, tnet = jb(10, image_size=32), tb(10, image_size=32)
    j_sparse, j_pruned = jg.sparsify(jnet, weights(jnet), density)
    t_pruned = params_from_numpy(j_pruned, device="cpu")
    t_sparse = sparse_from_numpy(j_sparse, device="cpu")
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    ref = _ref_traffic(jnet, j_pruned, jnp.asarray(x))
    port = tg.collect_conv_traffic(tnet, t_pruned, torch.from_numpy(x))
    return request.param, (ref, j_sparse), (port, t_sparse), tnet, \
        t_pruned, x


def test_collect_conv_traffic_records_the_reference_layers(traffic):
    _, (ref, _), (port, _), tnet, _, _ = traffic
    assert [(r[0], *r[3:]) for r in port] == [(r[0], *r[3:]) for r in ref]
    assert len(port) == len(tnet.conv_layers())
    for (_, xa, wa, *_), (_, xb, wb, *_) in zip(port, ref):
        assert tuple(xa.shape) == xb.shape
        np.testing.assert_array_equal(wa.numpy(), wb)
        np.testing.assert_allclose(xa.numpy(), xb, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(xb).max()))


@pytest.mark.parametrize("pe", ["4x14x3", "8x7x3"])
def test_network_cycle_reports_match_reference(traffic, pe):
    _, (ref, _), (port, _), _, _, _ = traffic
    tpe, rpe = PES[pe]
    got = T.network_cycle_reports(port, tpe)
    want = R.network_cycle_reports(ref, rpe)
    assert [(n, dataclasses.asdict(r)) for n, r in got] == \
        [(n, dataclasses.asdict(r)) for n, r in want]
    assert dataclasses.asdict(T.aggregate([r for _, r in got])) == \
        dataclasses.asdict(R.aggregate([r for _, r in want]))


def test_network_traffic_reports_match_reference(traffic):
    _, (ref, j_sparse), (port, t_sparse), _, _, _ = traffic
    got = T.network_traffic_reports(port, t_sparse)
    want = R.network_traffic_reports(ref, j_sparse)
    assert [(n, {k: dataclasses.asdict(v) for k, v in d.items()})
            for n, d in got] == \
        [(n, {k: dataclasses.asdict(v) for k, v in d.items()})
         for n, d in want]


def test_sparse_path_activations_give_the_dense_path_cycles(traffic):
    """The sparse path's recorded inputs (`collect_conv_traffic(sparse=)`,
    the plain path on the CPU) give the dense forward's cycle counts
    within 0.1%, the bound the card's phase holds the kernels to."""
    _, _, (port, t_sparse), tnet, t_pruned, x = traffic
    sparse_rec = tg.collect_conv_traffic(tnet, t_pruned, torch.from_numpy(x),
                                         sparse=t_sparse, impl="plain")
    a = T.aggregate([r for _, r in T.network_cycle_reports(port,
                                                           T.PE_4_14_3)])
    b = T.aggregate([r for _, r in T.network_cycle_reports(sparse_rec,
                                                           T.PE_4_14_3)])
    assert a.dense == b.dense
    assert abs(a.vscnn - b.vscnn) <= 1e-3 * a.vscnn
