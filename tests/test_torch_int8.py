"""The port's int8 quantizers and int8 plain kernels against the reference.

The reference makes int8 exact: weights and activations quantize to int8
at power-of-two scales, every stored step's int8 x int8 partial is an
exact integer, the partials enter an f32 accumulator in stored order and
the dequant multiply is exact.  So every comparison here is bit for bit
(``assert_array_equal``).  On a CPU tensor a kernel wrapper runs its plain
version, so these hold the plain versions (the port's CPU path and the
CUDA kernels' oracle on the card) against:

* vsmm: the reference's `vsmm_pallas` in interpret mode (`kernels.ops`);
* the halo conv and the depthwise halo conv: the reference's
  ``vs_conv2d(impl="jnp")`` (its halo Pallas kernels need `pl.Unblocked`,
  which this jax lacks).

Inputs are made with numpy from a seed and handed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core import sparse_ops as jops
from repro.core import vector_sparse as jv
from repro.core.pruning import prune_vectors_balanced
from repro.kernels import ops as jk
from repro.models import graph as jg
from repro_torch.core import sparse_ops as tops
from repro_torch.core import vector_sparse as tv
from repro_torch.kernels import vsconv as tvsconv
from repro_torch.kernels import vsconv_dw as tvsdw
from repro_torch.kernels import vsmm as tvsmm
from repro_torch.models import graph as tg


# --------------------------------------------------------------------------
# Quantizers
# --------------------------------------------------------------------------

def test_pow2_up_matches_reference_at_and_between_powers():
    s = np.array([1.0, 0.5, 2.0 ** -20, 2.0 ** 10, 3.0, 0.75, 1e-3,
                  np.nextafter(np.float32(1.0), np.float32(2.0)),
                  np.nextafter(np.float32(1.0), np.float32(0.0)), 127.0],
                 np.float32)
    s = np.concatenate([s, np.random.default_rng(0).uniform(
        1e-4, 10, 200).astype(np.float32)])
    p = tg._pow2_up(s)
    assert_array_equal(p, jg._pow2_up(s))
    assert p.dtype == np.float32
    assert_array_equal(p[:4], s[:4])  # exact powers stay (the p < s guard)
    assert p[7] == 2.0 and p[8] == 1.0


def test_weight_scales_and_quantize_match_reference():
    rng = np.random.default_rng(1)
    wm = rng.standard_normal((96, 64)).astype(np.float32)
    wm[:, 7] = 0.0                    # an all-zero (pad) column -> 1.0
    wm[:, 8] = 0.0
    wm[0, 8] = 127.0 * 2.0 ** -3      # max|w| / 127 an exact power of two
    s = tg.weight_scales(wm)
    assert_array_equal(s, jg.weight_scales(wm))
    assert s[7] == 1.0 and s[8] == 2.0 ** -3
    # .5 ties: w / s lands on k + 0.5, rounded half to even
    wm[1:9, 8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                          np.float32) * 2.0 ** -3
    q = tg.quantize_weights_int8(wm, s)
    assert_array_equal(q, jg.quantize_weights_int8(wm, s))
    assert q.dtype == np.int8
    assert_array_equal(q[1:9, 8], [0, 2, 2, 0, -2, -2, 126, -126])
    assert_array_equal(tg.quantize_weights_int8(wm * 4, s),
                       jg.quantize_weights_int8(wm * 4, s))  # clipped


@pytest.mark.parametrize("case", ["random", "zeros", "pow2_max", "ties",
                                  "negative_max"])
def test_quantize_activations_matches_reference(case):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 5, 16)).astype(np.float32)
    if case == "zeros":
        x[:] = 0                      # sx = 1, every code 0
    elif case == "pow2_max":
        x = np.clip(x, -1, 1)
        x[0, 0, 0, 0] = 127.0 * 2.0 ** -5   # sx exactly 2^-5: no doubling
    elif case == "ties":
        x[0, 0, 0, 0] = 127.0 * 2.0 ** -4   # sx = 2^-4
        k = rng.integers(-126, 126, size=x.shape[1:]).astype(np.float32)
        x[1] = (k + 0.5) * 2.0 ** -4         # every code a .5 tie
    elif case == "negative_max":
        x[1, 2, 3, 4] = -50.0
    xq, sx = tg.quantize_activations_int8(torch.from_numpy(x))
    jq, jsx = jg.quantize_activations_int8(jnp.asarray(x))
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32
    assert sx.shape == ()
    assert_array_equal(xq.numpy(), np.asarray(jq))
    assert_array_equal(sx.numpy(), np.asarray(jsx))
    if case == "zeros":
        assert float(sx) == 1.0 and not xq.any()
    if case == "pow2_max":
        assert float(sx) == 2.0 ** -5 and int(xq.max()) == 127
    if case == "ties":
        assert_array_equal(xq[1].numpy(),
                           np.round(x[1] / 2.0 ** -4).astype(np.int8))


def test_vector_sparse_astype():
    vs = tv.from_mask(torch.arange(64.0).reshape(8, 8),
                      np.ones((2, 2), bool), 4, 4)
    q = vs.astype(torch.int8)
    assert q.dtype == torch.int8 and q.idx is vs.idx and q.shape == vs.shape
    assert torch.equal(q.vals, vs.vals.to(torch.int8))


def test_check_operands_takes_int8_only_with_a_scale():
    x8 = torch.zeros(4, 8, dtype=torch.int8)
    v8 = torch.zeros(1, 1, 8, 4, dtype=torch.int8)
    idx = torch.zeros(1, 1, dtype=torch.int32)
    s = torch.ones(4)
    dev = torch.device("cpu")
    assert tvsmm.check_operands({"x": x8, "vals": v8, "idx": idx,
                                 "scale": s}, dev)
    assert not tvsmm.check_operands({"x": x8.float(), "vals": v8.float(),
                                     "idx": idx, "scale": s}, dev)
    for bad in ({"x": x8, "vals": v8, "idx": idx, "scale": None},
                {"x": x8, "vals": v8.float(), "idx": idx, "scale": s},
                {"x": x8.float(), "vals": v8, "idx": idx, "scale": s},
                {"x": x8, "vals": v8, "idx": idx, "scale": s.double()},
                {"x": x8, "vals": v8, "idx": idx.long(), "scale": s}):
        with pytest.raises(ValueError):
            tvsmm.check_operands(bad, dev)
    assert tvsmm.entry_name("vsmm_launch", True) == "vsmm_int8_launch"
    # int8 stems take the stem body (its int8 twin) under the f32 rule
    assert tvsconv.use_stem_body(8, 8, 1, 7, 7, 64, stride=2, int8=True)
    assert tvsconv.use_stem_body(8, 8, 1, 7, 7, 64, stride=2)


# --------------------------------------------------------------------------
# Plain kernels on int8 operands
# --------------------------------------------------------------------------

def _quantized_pair(k, n, vk, vn, density, seed, *, cb=None):
    """The same int8-encoded weight on both sides, as `sparsify` makes it
    (cin-major for a conv with ``cb`` cin tiles), and its scales."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)
    if density < 1:
        wp, mask = prune_vectors_balanced(w, density, vk, vn)
    else:
        wp, mask = w, np.ones((k // vk, n // vn), bool)
    s = jg.weight_scales(wp)
    wq = jg.quantize_weights_int8(wp, s)
    jvs = jv.from_mask(jnp.asarray(wq), mask, vk, vn)
    tvs = tv.from_mask(torch.from_numpy(wq), mask, vk, vn)
    if cb is not None:
        jvs, tvs = jv.conv_cin_major(jvs, cb), tv.conv_cin_major(tvs, cb)
    return jvs, tvs, s


def _int8_act(shape, seed):
    """Quantized post-ReLU-like activations with a zero run (the
    input-side skip) and the scale, from the reference's quantizer."""
    x = np.maximum(np.random.default_rng(seed).standard_normal(shape), 0)
    x[..., : shape[-1] // 4] = 0
    xq, sx = jg.quantize_activations_int8(jnp.asarray(x, jnp.float32))
    return np.array(xq), np.array(sx)


def _epilogue(epi, scale, n, out_shape, seed):
    """(reference kwargs, port kwargs): the combined scale, and with
    ``epi`` a bias, a residual and the ReLU."""
    j = dict(scale=jnp.asarray(scale))
    t = dict(scale=torch.from_numpy(scale))
    if epi:
        rng = np.random.default_rng(seed)
        b = rng.standard_normal(n).astype(np.float32)
        r = rng.standard_normal(out_shape).astype(np.float32)
        j.update(bias=jnp.asarray(b), residual=jnp.asarray(r),
                 fuse_relu=True)
        t.update(bias=torch.from_numpy(b), residual=torch.from_numpy(r),
                 fuse_relu=True)
    return j, t


@pytest.mark.parametrize("m,k,n,vk,vn,density", [
    (37, 64, 20, 8, 10, 0.5),       # ragged M, a 10-wide strip
    (64, 512, 256, 32, 128, 0.25),  # a 1x1 projection's tiles
    (8, 512, 1024, 32, 128, 0.25),  # an FC head at batch 8
])
@pytest.mark.parametrize("epi", [False, True])
def test_vsmm_int8_matches_pallas_interpret(m, k, n, vk, vn, density, epi):
    jvs, tvs, s_w = _quantized_pair(k, n, vk, vn, density, 10)
    xq, sx = _int8_act((m, k), 11)
    scale = (sx * s_w).astype(np.float32)
    jkw, tkw = _epilogue(epi, scale, n, (m, n), 12)
    ref = jk.vsmm(jnp.asarray(xq), jvs, **jkw)  # Pallas, interpret mode
    y = tvsmm.vsmm_kernel(torch.from_numpy(xq), tvs, **tkw)
    assert y.dtype == torch.float32
    assert_array_equal(y.numpy(), np.asarray(ref))
    assert_array_equal(
        tops.vs_matmul(torch.from_numpy(xq), tvs, **tkw).numpy(),
        np.asarray(ref))


def test_vsmm_int8_keeps_stored_step_order_past_2_pow_24():
    """±127 weight tiles over 64 stored steps against activations of 127
    and 126 (so a step's partial may be odd): the f32 sum passes 2^24,
    the f32 adds round, and only the reference's order (each step's exact
    partial added in stored order) gives its bits."""
    rng = np.random.default_rng(3)
    m, k, n, vk, vn = 16, 2048, 128, 32, 128
    wq = np.where(rng.random((k, n)) < 0.9, 127, -127).astype(np.int8)
    xq = np.where(rng.random((m, k)) < 0.5, 127, 126).astype(np.int8)
    mask = np.ones((k // vk, n // vn), bool)
    jvs = jv.from_mask(jnp.asarray(wq), mask, vk, vn)
    tvs = tv.from_mask(torch.from_numpy(wq), mask, vk, vn)
    scale = np.ones(n, np.float32)
    ref = np.asarray(jk.vsmm(jnp.asarray(xq), jvs, scale=jnp.asarray(scale)))
    y = tvsmm.vsmm_kernel(torch.from_numpy(xq), tvs,
                          scale=torch.from_numpy(scale)).numpy()
    assert_array_equal(y, ref)
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    # another order gives other bits: the exact sum rounded once, and the
    # steps added in reverse
    assert not np.array_equal(exact.astype(np.float32), ref)
    parts = np.stack([xq[:, s * vk:(s + 1) * vk].astype(np.int64)
                      @ wq[s * vk:(s + 1) * vk].astype(np.int64)
                      for s in range(k // vk)]).astype(np.float32)
    rev = np.zeros((m, n), np.float32)
    for p in parts[::-1]:
        rev += p
    assert not np.array_equal(rev, ref)


# cin, cout, kh, stride, groups, vk, vn, density, h: the ResNet-18 stem
# (cin 3 -> 8, vk 8, dense), 3x3 s1 and s2, a grouped conv and an input
# whose Hout < 4 (the reference's resident halo layout)
CONVS = [
    (8, 64, 7, 2, 1, 8, 64, 1.0, 16),
    (64, 64, 3, 1, 1, 32, 64, 0.5, 8),
    (64, 128, 3, 2, 1, 32, 128, 0.25, 8),
    (64, 64, 3, 1, 4, 16, 16, 0.5, 6),
    (128, 128, 3, 1, 1, 32, 128, 0.5, 2),
]


@pytest.mark.parametrize("cin,cout,kh,stride,groups,vk,vn,density,h", CONVS)
@pytest.mark.parametrize("epi", [False, True])
def test_halo_conv_int8_matches_reference_jnp(cin, cout, kh, stride, groups,
                                              vk, vn, density, h, epi):
    cin_g = cin // groups
    jvs, tvs, s_w = _quantized_pair(kh * kh * cin_g, cout, vk, vn, density,
                                    20, cb=cin_g // vk)
    xq, sx = _int8_act((2, h, h, cin), 21)
    if cin == 8:
        xq[..., 3:] = 0  # the stem's cin padding 3 -> 8
    ho = -(-h // stride)
    scale = (sx * s_w).astype(np.float32)
    jkw, tkw = _epilogue(epi, scale, cout, (2, ho, ho, cout), 22)
    geo = dict(kh=kh, kw=kh, stride=stride, groups=groups)
    ref = np.asarray(jops.vs_conv2d(jnp.asarray(xq), jvs, impl="jnp", **geo,
                                    **jkw))
    xt = torch.from_numpy(xq)
    # the halo kernel's wrapper on the halo buffer (its plain version here)
    xh = tvsconv.build_halo_input(xt, kh=kh, kw=kh, stride=stride, vk=vk)
    assert xh.dtype == torch.int8
    y = tvsconv.vsconv_halo_kernel(xh, tvs, w_out=ho, **geo, **tkw)
    assert y.dtype == torch.float32
    assert_array_equal(y.numpy(), ref)
    # the dispatch (halo layout, int8 zero padding) and the plain path
    for impl in ("pallas", "plain"):
        assert_array_equal(
            tops.vs_conv2d(xt, tvs, impl=impl, **geo, **tkw).numpy(), ref)


@pytest.mark.parametrize("c,vc,stride,h", [
    (32, 32, 1, 9),     # MobileNetV1's dw1 channel tile
    (64, 64, 2, 10),    # dw2's stride 2
    (256, 128, 2, 5),   # two 128-channel tiles, stride 2
])
@pytest.mark.parametrize("epi", [False, True])
def test_dw_halo_int8_matches_reference_jnp(c, vc, stride, h, epi):
    jvs, tvs, s_w = _quantized_pair(9, c, 1, vc, 0.5, 30)
    xq, sx = _int8_act((2, h, h, c), 31)
    ho = -(-h // stride)
    scale = (sx * s_w).astype(np.float32)
    jkw, tkw = _epilogue(epi, scale, c, (2, ho, ho, c), 32)
    ref = np.asarray(jops.vs_conv2d(jnp.asarray(xq), jvs, kh=3, kw=3,
                                    stride=stride, groups=c, impl="jnp",
                                    **jkw))
    xt = torch.from_numpy(xq)
    xh = tvsconv.build_halo_input(xt, kh=3, kw=3, stride=stride, vk=vc)
    y = tvsdw.vsconv_dw_halo_kernel(xh, tvs, w_out=ho, stride=stride, **tkw)
    assert y.dtype == torch.float32
    assert_array_equal(y.numpy(), ref)
    assert_array_equal(tops.vs_conv2d(xt, tvs, kh=3, kw=3, stride=stride,
                                      groups=c, impl="pallas",
                                      **tkw).numpy(), ref)
