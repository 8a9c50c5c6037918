"""The port's grouped and depthwise convs against the JAX reference, on the
CPU.

Encodings are compared byte for byte with the reference's
`sparse_conv_from_dense`.  The convs — the plain `vs_conv2d` branches,
`kernels.ops.vsconv` (which on CPU tensors runs the kernels' plain
versions) and `vsconv_dw_plain` on the halo buffer — are held against the
reference's structural ``impl="jnp"`` path and its dense oracle
`kernels/ref.py::vsconv_ref`.  The reference's depthwise halo Pallas kernel
is not an oracle here: it needs `pl.Unblocked`, which this jax lacks.

Tolerance: relative 1e-5 of max|y| — the only difference is the order of
the f32 sums.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_ops as jops
from repro.kernels import ref as jref
from repro.models import graph as jg
from repro_torch.core import sparse_ops as tops
from repro_torch.kernels import ops as tk
from repro_torch.kernels import ref as tref
from repro_torch.kernels import vsconv as tvsconv
from repro_torch.kernels import vsconv_dw as tdw
from repro_torch.models import graph as tg

jvsconv = importlib.import_module("repro.kernels.vsconv")

RTOL = 1e-5


def _assert_close(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    assert y.shape == ref.shape
    err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= RTOL, err


def _act(shape, seed):
    """Post-ReLU-like activations with a zero run (input-side skip)."""
    x = np.maximum(np.random.default_rng(seed).standard_normal(shape), 0)
    x[..., : shape[-1] // 4] = 0
    return x.astype(np.float32)


def _encode(w, density, groups, vk=32, vn=128):
    """The same dense weight encoded by both sides."""
    j, jw = jg.sparse_conv_from_dense(w, density, vk=vk, vn=vn,
                                      groups=groups)
    t, tw = tg.sparse_conv_from_dense(w, density, vk=vk, vn=vn,
                                      groups=groups)
    return j, t, jw, tw


ENCODINGS = [  # kh, cin/groups, cout, groups, vk, vn
    (3, 1, 32, 32, 32, 128),     # MobileNet dw1: one strip of 32
    (3, 1, 256, 256, 32, 128),   # two strips of 128
    (3, 1, 96, 96, 32, 64),      # vn shrinks to 48
    (3, 16, 64, 4, 32, 128),     # grouped: vk 16, vn 16
    (1, 16, 64, 4, 32, 128),     # grouped 1x1
    (5, 8, 32, 2, 32, 128),      # grouped 5x5, cin 8 per group
]


@pytest.mark.parametrize("kh,cin_g,cout,groups,vk,vn", ENCODINGS)
@pytest.mark.parametrize("density", [1.0, 0.5, 0.25])
def test_encoding_byte_equal_to_reference(kh, cin_g, cout, groups, vk, vn,
                                          density):
    w = np.random.default_rng(cout + kh).standard_normal(
        (kh, kh, cin_g, cout)).astype(np.float32)
    j, t, jw, tw = _encode(w, density, groups, vk, vn)
    assert t.vs.vals.numpy().tobytes() == np.asarray(j.vs.vals).tobytes()
    assert t.vs.idx.numpy().tobytes() == np.asarray(j.vs.idx).tobytes()
    assert t.vs.idx.dtype == torch.int32
    assert t.vs.shape == tuple(j.vs.shape)
    assert (t.kh, t.kw, t.stride, t.groups, t.dilation, t.cin_pad) == (
        j.kh, j.kw, j.stride, j.groups, j.dilation, j.cin_pad)
    assert tw.tobytes() == np.asarray(jw).tobytes()


CONVS = [  # C in, C out, groups, vn, stride, dilation
    (64, 64, 64, 32, 1, 1),     # depthwise, 2 strips of 32
    (64, 64, 64, 32, 2, 1),     # depthwise s2: asymmetric SAME pads
    (48, 48, 48, 48, 1, 2),     # depthwise dilated, vc 48
    (32, 64, 4, 128, 1, 1),     # grouped 3x3 (vk 8, vn 16)
    (32, 64, 4, 128, 2, 2),     # grouped, strided, dilated
]


@pytest.mark.parametrize("cin,cout,groups,vn,stride,dil", CONVS)
@pytest.mark.parametrize("epi", [False, True])
def test_vs_conv2d_matches_reference(cin, cout, groups, vn, stride, dil,
                                     epi):
    rng = np.random.default_rng(cin + groups + stride + dil)
    w = rng.standard_normal((3, 3, cin // groups, cout)).astype(np.float32)
    j, t, _, _ = _encode(w, 0.5, groups, vk=32, vn=vn)
    x = _act((2, 11, 11, cin), cin)
    ho = -(-11 // stride)
    jkw, tkw = {}, {}
    if epi:
        b = rng.standard_normal(cout).astype(np.float32)
        r = rng.standard_normal((2, ho, ho, cout)).astype(np.float32)
        jkw = dict(bias=jnp.asarray(b), residual=jnp.asarray(r),
                   fuse_relu=True)
        tkw = dict(bias=torch.from_numpy(b), residual=torch.from_numpy(r),
                   fuse_relu=True)
    geo = dict(kh=3, kw=3, stride=stride, groups=groups, dilation=dil)
    y_jnp = np.asarray(jops.vs_conv2d(jnp.asarray(x), j.vs, impl="jnp",
                                      **geo, **jkw))
    y_ref = np.asarray(jref.vsconv_ref(jnp.asarray(x), j.vs, **geo, **jkw))
    xt = torch.from_numpy(x)
    for y in (tops.vs_conv2d(xt, t.vs, impl="plain", **geo, **tkw),
              tops.vs_conv2d(xt, t.vs, impl="pallas", **geo, **tkw),
              tops.vs_conv2d(xt, t.vs, impl="pallas-stack", **geo, **tkw),
              tk.vsconv(xt, t.vs, impl="halo", **geo, **tkw),
              tref.vsconv_ref(xt, t.vs, **geo, **tkw)):
        _assert_close(y, y_jnp)
        _assert_close(y, y_ref)


@pytest.mark.parametrize("c,vn,stride,dil,h", [
    (32, 128, 1, 1, 16),   # dw1-like: vc 32
    (64, 128, 2, 1, 16),   # dw2-like: 16 -> 8, pads (0, 1)
    (256, 128, 2, 1, 7),   # dw12-like at 7 px: 7 -> 4, pads (1, 1)
    (48, 16, 1, 2, 9),     # 3 strips of 16, dilated
])
@pytest.mark.parametrize("density", [1.0, 0.5])
def test_dw_plain_on_halo_buffer_matches_reference(c, vn, stride, dil, h,
                                                   density):
    """`vsconv_dw_plain` — the depthwise halo kernel's plain version, on
    `build_halo_input(x, vk=vc)` — against the reference's jnp path and
    dense oracle; the halo buffer itself is byte-equal to the
    reference's."""
    w = np.random.default_rng(c + h).standard_normal(
        (3, 3, 1, c)).astype(np.float32)
    j, t, _, _ = _encode(w, density, c, vn=vn)
    x = _act((2, h, h, c), c + 1)
    ho = -(-h // stride)
    rng = np.random.default_rng(h)
    b = rng.standard_normal(c).astype(np.float32)
    r = rng.standard_normal((2, ho, ho, c)).astype(np.float32)
    geo = dict(kh=3, kw=3, stride=stride, dilation=dil)
    xh = tvsconv.build_halo_input(torch.from_numpy(x), vk=t.vs.vn, **geo)
    jxh = jvsconv.build_halo_input(jnp.asarray(x), vk=j.vs.vn, **geo)
    assert xh.numpy().tobytes() == np.asarray(jxh).tobytes()
    y = tdw.vsconv_dw_plain(xh, t.vs, w_out=ho, bias=torch.from_numpy(b),
                            residual=torch.from_numpy(r), fuse_relu=True,
                            **geo)
    jkw = dict(bias=jnp.asarray(b), residual=jnp.asarray(r), fuse_relu=True)
    _assert_close(y, jops.vs_conv2d(jnp.asarray(x), j.vs, impl="jnp",
                                    groups=c, **geo, **jkw))
    _assert_close(y, jref.vsconv_ref(jnp.asarray(x), j.vs, groups=c, **geo,
                                     **jkw))
    assert torch.equal(
        tdw.vsconv_dw_halo_kernel(xh, t.vs, w_out=ho, **geo),
        tdw.vsconv_dw_plain(xh, t.vs, w_out=ho, **geo))


@pytest.mark.parametrize("groups", [64, 4])
def test_ref_oracle_pins_reference(groups):
    """`kernels/ref.py::vsconv_ref` at groups == C (the depthwise
    (kh*kw, C) case) and at groups == 4, against the reference oracle."""
    w = np.random.default_rng(groups).standard_normal(
        (3, 3, 64 // groups, 64)).astype(np.float32)
    j, t, _, _ = _encode(w, 0.5, groups, vk=8, vn=32)
    x = _act((2, 9, 9, 64), groups)
    for stride, dil in ((1, 1), (2, 1), (1, 2)):
        geo = dict(kh=3, kw=3, stride=stride, groups=groups, dilation=dil)
        _assert_close(tref.vsconv_ref(torch.from_numpy(x), t.vs, **geo),
                      jref.vsconv_ref(jnp.asarray(x), j.vs, **geo))


def test_dw_halo_cost_matches_reference():
    for stride, dil in ((1, 1), (2, 2)):
        kw = dict(n=8, hop=16, w_out=14, kh=3, stride=stride, bwp=32, bh=8,
                  nb=4, s_steps=5, vc=128, dilation=dil, residual_bytes=7)
        est = jvsconv.dw_halo_kernel_cost(**kw)
        assert tdw.dw_halo_kernel_cost(**kw) == {
            "flops": est.flops, "bytes_accessed": est.bytes_accessed}


def test_depthwise_dispatch_and_refusals():
    """A channel-multiplier conv is not depthwise (it takes the grouped
    path); malformed tap matrices raise."""
    w = np.ones((3, 3, 1, 32), np.float32)
    _, t, _, _ = _encode(w, 0.5, 32)
    assert tops.is_depthwise(32, 32, t.vs, 3, 3)
    assert not tops.is_depthwise(1, 32, t.vs, 3, 3)
    assert not tops.is_depthwise(32, 32, t.vs, 1, 1)
    xh = tvsconv.build_halo_input(torch.zeros(1, 6, 6, 32), vk=32)
    with pytest.raises(ValueError, match="does not match"):
        tdw.vsconv_dw_plain(xh, t.vs, w_out=2, kh=5, kw=5)
    with pytest.raises(ValueError, match="does not match"):
        tops.patch_conv(torch.zeros(1, 2, 2, 9 * 64), t.vs, taps=9,
                        groups=64, depthwise=True)
