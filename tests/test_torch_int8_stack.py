"""The int8 branches of the port's two stack kernels against the reference.

The reference makes int8 exact (power-of-two scales, each stored step's
int8 x int8 partial an exact integer, added into an f32 accumulator in
stored order), so every comparison here is bit for bit.  On a CPU tensor a
kernel wrapper runs its plain version, so these hold the plain versions
(the port's CPU path and the CUDA kernels' oracle on the card) against:

* the stack conv: the reference's `vsconv_pallas` in interpret mode;
* the depthwise stack conv: its `vsconv_dw_stack_pallas` in interpret
  mode;
* whole networks (ResNet-18 and MobileNetV1 at 32 px) and the int8 stack
  serving path: the reference's int8 ``impl="jnp"`` logits (the
  reference's jnp and pallas-stack paths agree to 0.0 on int8).

Inputs are made with numpy from a seed and handed to both sides.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core import vector_sparse as jv
from repro.core.pruning import prune_vectors_balanced
from repro.models import graph as jg
from repro_torch.configs import get_config
from repro_torch.core import sparse_ops as tops
from repro_torch.core import vector_sparse as tv
from repro_torch.kernels import vsconv as tvsconv
from repro_torch.kernels import vsconv_dw as tdw
from repro_torch.launch.serve import CNNServer, ImageRequest
from repro_torch.models import graph as tg
from repro_torch.params import params_from_numpy

jvsconv = importlib.import_module("repro.kernels.vsconv")


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


# cin, cout, kh, stride, groups, vk, vn, density, h: the ResNet-18 stem
# (cin 3 -> 8, vk 8, dense: 14 int8 planes), 3x3 s1 and s2, a grouped conv
# and an input whose Hout < 4
CONVS = [
    (8, 64, 7, 2, 1, 8, 64, 1.0, 16),
    (64, 64, 3, 1, 1, 32, 64, 0.5, 8),
    (64, 128, 3, 2, 1, 32, 128, 0.25, 8),
    (64, 64, 3, 1, 4, 16, 16, 0.5, 6),
    (128, 128, 3, 1, 1, 32, 128, 0.5, 2),
]


@pytest.mark.parametrize("cin,cout,kh,stride,groups,vk,vn,density,h", CONVS)
@pytest.mark.parametrize("epi", [False, True])
def test_stack_conv_int8_matches_pallas_interpret(cin, cout, kh, stride,
                                                  groups, vk, vn, density, h,
                                                  epi):
    cin_g = cin // groups
    jvs, tvs, s_w = _quantized_pair(kh * kh * cin_g, cout, vk, vn, density,
                                    40, cb=cin_g // vk)
    xq, sx = _int8_act((2, h, h, cin), 41)
    if cin == 8:
        xq[..., 3:] = 0  # the stem's cin padding 3 -> 8
    ho = -(-h // stride)
    scale = (sx * s_w).astype(np.float32)
    jkw, tkw = _epilogue(epi, scale, cout, (2, ho, ho, cout), 42)
    geo = dict(kh=kh, kw=kh, stride=stride)
    xt = tvsconv.build_row_tap_stack(torch.from_numpy(xq), **geo)
    assert xt.dtype == torch.int8
    ref = np.asarray(jvsconv.vsconv_pallas(
        jnp.asarray(xt.numpy()), jvs, w_out=ho, groups=groups, bh=ho,
        interpret=True, **geo, **jkw))
    before = (tvsconv.vsconv_stack_kernel.launches,
              tvsconv.vsconv_stack_kernel.int8_launches)
    y = tvsconv.vsconv_stack_kernel(xt, tvs, w_out=ho, groups=groups, **geo,
                                    **tkw)
    assert y.dtype == torch.float32
    assert_array_equal(y.numpy(), ref)
    # on a CPU tensor the wrapper is the plain version, not a launch
    assert (tvsconv.vsconv_stack_kernel.launches,
            tvsconv.vsconv_stack_kernel.int8_launches) == before
    assert_array_equal(tops.vs_conv2d(
        torch.from_numpy(xq), tvs, groups=groups, impl="pallas-stack", **geo,
        **tkw).numpy(), ref)


def test_stack_conv_int8_keeps_stored_step_order_past_2_pow_24():
    """±127 weight tiles over 72 stored steps (3x3, 256 channels in tiles
    of 32) against codes of 127 and 126: the f32 sum passes 2^24, the f32
    adds round, and only the reference's order (each step's exact partial
    added in stored order) gives its bits."""
    rng = np.random.default_rng(43)
    k, n, vk, vn, c = 9 * 256, 128, 32, 128, 256
    wq = np.where(rng.random((k, n)) < 0.9, 127, -127).astype(np.int8)
    xq = np.where(rng.random((1, 4, 4, c)) < 0.5, 127, 126).astype(np.int8)
    mask = np.ones((k // vk, n // vn), bool)
    jvs = jv.conv_cin_major(jv.from_mask(jnp.asarray(wq), mask, vk, vn),
                            c // vk)
    tvs = tv.conv_cin_major(tv.from_mask(torch.from_numpy(wq), mask, vk, vn),
                            c // vk)
    scale = np.ones(n, np.float32)
    xt = tvsconv.build_row_tap_stack(torch.from_numpy(xq), kh=3, kw=3)
    ref = np.asarray(jvsconv.vsconv_pallas(
        jnp.asarray(xt.numpy()), jvs, w_out=4, bh=4, interpret=True,
        scale=jnp.asarray(scale)))
    y = tvsconv.vsconv_stack_plain(xt, tvs, w_out=4,
                                   scale=torch.from_numpy(scale)).numpy()
    assert_array_equal(y, ref)
    # the exact sum passes 2^24, so rounding it once gives other bits
    patches = tvsconv.stack_patches(xt, kh=3, kw=3, stride=1, dilation=1,
                                    w_out=4).numpy().astype(np.int64)
    dense = tv.decode(tvs).numpy().astype(np.int64)
    exact = patches.reshape(-1, k) @ dense
    assert np.abs(exact).max() > 2 ** 24
    assert not np.array_equal(exact.astype(np.float32).reshape(y.shape), y)


@pytest.mark.parametrize("c,vc,stride,h", [
    (32, 32, 1, 9),     # MobileNetV1's dw1 channel tile
    (64, 64, 2, 10),    # dw2's stride 2
    (256, 128, 2, 5),   # two 128-channel tiles, stride 2
])
@pytest.mark.parametrize("epi", [False, True])
def test_dw_stack_int8_matches_pallas_interpret(c, vc, stride, h, epi):
    jvs, tvs, s_w = _quantized_pair(9, c, 1, vc, 0.5, 44)
    xq, sx = _int8_act((2, h, h, c), 45)
    ho = -(-h // stride)
    scale = (sx * s_w).astype(np.float32)
    jkw, tkw = _epilogue(epi, scale, c, (2, ho, ho, c), 46)
    geo = dict(kh=3, kw=3, stride=stride)
    xt = tvsconv.build_row_tap_stack(torch.from_numpy(xq), **geo)
    ref = np.asarray(jvsconv.vsconv_dw_stack_pallas(
        jnp.asarray(xt.numpy()), jvs, w_out=ho, bh=ho, interpret=True, **geo,
        **jkw))
    y = tdw.vsconv_dw_stack_kernel(xt, tvs, w_out=ho, **geo, **tkw)
    assert y.dtype == torch.float32
    assert_array_equal(y.numpy(), ref)
    assert_array_equal(tops.vs_conv2d(
        torch.from_numpy(xq), tvs, groups=c, impl="pallas-stack", **geo,
        **tkw).numpy(), ref)


NETS = {"resnet18": (jg.build_resnet18, tg.build_resnet18),
        "mobilenet_v1": (jg.build_mobilenet_v1, tg.build_mobilenet_v1)}


def _weights(schema, seed):
    """A numpy tree for the reference's schema: normal weights at
    fan_in^-1/2, randomised BN statistics, zero biases."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, leaves in schema.items():
        tree[name] = {}
        for leaf, p in leaves.items():
            if p.init == "normal":
                v = rng.standard_normal(p.shape) * p.fan_in ** -0.5
            elif leaf in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, p.shape)
            elif leaf in ("offset", "mean"):
                v = rng.normal(0, 0.1, p.shape)
            else:
                v = np.zeros(p.shape)
            tree[name][leaf] = v.astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(47).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(NETS))
def test_int8_stack_net_bit_equal_to_reference(images, name):
    """ResNet-18 and MobileNetV1 at 32 px, int8, density 0.5, BN
    statistics randomised: the port's ``impl="pallas-stack"`` on the CPU
    (every conv through a stack wrapper) bit-equal to the reference's
    int8 ``impl="jnp"`` (one jitted forward)."""
    jb, tb = NETS[name]
    jnet, tnet = jb(10), tb(10)
    tree = _weights(jnet.schema(), 5)
    jw = jax.tree.map(jnp.asarray, tree)
    jsparse, _ = jg.sparsify(jnet, jw, 0.5, dtype="int8")
    ref = np.asarray(jax.jit(lambda w, x: jg.net_apply(
        jnet, w, x, sparse=jsparse, impl="jnp"))(jw, jnp.asarray(images)))
    tparams = params_from_numpy(tree, "cpu")
    tsparse, _ = tg.sparsify(tnet, tparams, 0.5, dtype="int8")
    y = tg.net_apply(tnet, tparams, torch.from_numpy(images),
                     sparse=tsparse, impl="pallas-stack")
    assert y.dtype == torch.float32
    assert_array_equal(y.numpy(), ref)


@pytest.mark.parametrize("arch", ["vscnn-resnet18", "vscnn-mobilenet-v1"])
def test_int8_stack_server_equals_direct_apply(arch):
    """`CNNServer(dtype="int8", impl="pallas-stack")` on the CPU: five
    requests at batch 4 (a full wave and a backfilled one), every request
    delivered and bit-equal to `net_apply` over the same waves, through
    the stack path and the plain one."""
    cfg = get_config(arch).reduce()
    srv = CNNServer(cfg, batch=4, density=0.5, seed=0, dtype="int8",
                    impl="pallas-stack", device="cpu")
    rng = np.random.default_rng(6)
    imgs = [rng.standard_normal((32, 32, 3)).astype(np.float32)
            for _ in range(5)]
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    stats = srv.serve(reqs)
    assert sum(s["images"] for s in stats) == 5
    with torch.inference_mode():
        waves = [torch.from_numpy(np.stack(imgs[a:b]))
                 for a, b in ((0, 4), (4, 5))]
        for impl in ("pallas-stack", "plain"):
            ref = torch.cat([tg.net_apply(srv.net, srv.params, x,
                                          sparse=srv.sparse, impl=impl)
                             for x in waves]).numpy()
            for i, r in enumerate(reqs):
                assert r.outcome.status == "delivered"
                assert_array_equal(r.logits, ref[i])
