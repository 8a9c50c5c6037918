"""The port's row-tap stack layout and its two kernels' plain versions
against the JAX reference, on the CPU.

`build_row_tap_stack` / `stack_layout_dims` are compared byte for byte.
`vsconv_stack_plain` and `vsconv_dw_stack_plain` (what the stack kernels'
wrappers run on CPU tensors) are held against the reference's Pallas
kernels `vsconv_pallas` and `vsconv_dw_stack_pallas` in interpret mode, on
the same stack and the same encoded weights.

Tolerance: relative 1e-5 of max|y| — the only difference is the order of
the f32 sums.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import graph as jg
from repro_torch.kernels import ops as tk
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


STACKS = [  # H, W, kh, kw, stride, dilation, C, h_out
    (224, 224, 7, 7, 2, 1, 8, None),   # the ResNet-18 stem (cin 3 -> 8)
    (224, 224, 3, 3, 2, 1, 8, None),   # the MobileNetV1 stem
    (56, 56, 3, 3, 1, 1, 16, None),
    (13, 9, 3, 5, 2, 2, 8, None),      # odd sizes, dilated, kh != kw
    (7, 7, 3, 3, 2, 1, 8, None),       # 7 -> 4
    (10, 10, 3, 3, 1, 1, 8, 16),       # Hout rounded up to a row block
    (12, 12, 2, 4, 2, 1, 8, None),     # even kernel
]


@pytest.mark.parametrize("h,w,kh,kw,stride,dil,c,h_out", STACKS)
def test_stack_layout_byte_equal(h, w, kh, kw, stride, dil, c, h_out):
    ho = h_out or -(-h // stride)
    geo = dict(kh=kh, kw=kw, stride=stride, dilation=dil)
    assert tvsconv.stack_layout_dims(h, w, h_out=ho, **geo) == \
        jvsconv.stack_layout_dims(h, w, h_out=ho, **geo)
    x = np.random.default_rng(h * w + kh).standard_normal(
        (2, h, w, c)).astype(np.float32)
    ours = tvsconv.build_row_tap_stack(torch.from_numpy(x), h_out=h_out,
                                       **geo).numpy()
    theirs = np.asarray(jvsconv.build_row_tap_stack(jnp.asarray(x),
                                                    h_out=h_out, **geo))
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert ours.tobytes() == theirs.tobytes()


def _epilogue(epi, shape, seed):
    if not epi:
        return {}, {}
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    return (dict(bias=jnp.asarray(b), residual=jnp.asarray(r),
                 fuse_relu=True),
            dict(bias=torch.from_numpy(b), residual=torch.from_numpy(r),
                 fuse_relu=True))


CONVS = [  # H, C in, C out, kh, stride, dilation, groups, vk, vn
    (16, 8, 32, 7, 2, 1, 1, 8, 32),     # stem-like 7x7/s2, vk 8
    (12, 64, 64, 3, 1, 1, 1, 32, 64),
    (12, 64, 128, 3, 2, 1, 1, 32, 128),
    (11, 32, 64, 3, 2, 2, 4, 32, 128),  # grouped, strided, dilated
    (8, 64, 64, 3, 1, 1, 4, 32, 128),   # grouped 3x3, 4 groups
]


@pytest.mark.parametrize("h,cin,cout,kh,stride,dil,groups,vk,vn", CONVS)
@pytest.mark.parametrize("epi", [False, True])
def test_stack_plain_matches_reference_kernel(h, cin, cout, kh, stride, dil,
                                              groups, vk, vn, epi):
    w = np.random.default_rng(h + cin + groups).standard_normal(
        (kh, kh, cin // groups, cout)).astype(np.float32)
    j, jw = jg.sparse_conv_from_dense(w, 0.5, vk=vk, vn=vn, groups=groups)
    t, _ = tg.sparse_conv_from_dense(w, 0.5, vk=vk, vn=vn, groups=groups)
    x = _act((2, h, h, cin), cin + kh)
    ho = -(-h // stride)
    jkw, tkw = _epilogue(epi, (2, ho, ho, cout), cout)
    geo = dict(kh=kh, kw=kh, stride=stride, dilation=dil)
    xt = tvsconv.build_row_tap_stack(torch.from_numpy(x), **geo)
    y_ref = np.asarray(jvsconv.vsconv_pallas(
        jnp.asarray(xt.numpy()), j.vs, w_out=ho, groups=groups, bh=ho,
        interpret=True, **geo, **jkw))
    y = tvsconv.vsconv_stack_plain(xt, t.vs, w_out=ho, groups=groups, **geo,
                                   **tkw)
    _assert_close(y, y_ref)
    # the wrapper on a CPU tensor is the plain version, not a launch
    before = tvsconv.vsconv_stack_kernel.launches
    assert torch.equal(tvsconv.vsconv_stack_kernel(
        xt, t.vs, w_out=ho, groups=groups, **geo, **tkw), y)
    assert tvsconv.vsconv_stack_kernel.launches == before
    _assert_close(tk.vsconv(torch.from_numpy(x), t.vs, groups=groups,
                            impl="stack", **geo, **tkw), y_ref)


DW = [  # H, C, stride, dilation, vn
    (16, 32, 1, 1, 128),   # dw1-like: vc 32
    (14, 512, 2, 1, 128),  # dw12-like: 14 -> 7, 4 strips
    (9, 48, 1, 2, 16),     # dilated, 3 strips of 16
    (7, 64, 2, 1, 32),     # 7 -> 4
]


@pytest.mark.parametrize("h,c,stride,dil,vn", DW)
@pytest.mark.parametrize("epi", [False, True])
def test_dw_stack_plain_matches_reference_kernel(h, c, stride, dil, vn, epi):
    w = np.random.default_rng(h + c).standard_normal(
        (3, 3, 1, c)).astype(np.float32)
    j, _ = jg.sparse_conv_from_dense(w, 0.5, vn=vn, groups=c)
    t, _ = tg.sparse_conv_from_dense(w, 0.5, vn=vn, groups=c)
    x = _act((2, h, h, c), c + h)
    ho = -(-h // stride)
    jkw, tkw = _epilogue(epi, (2, ho, ho, c), c)
    geo = dict(kh=3, kw=3, stride=stride, dilation=dil)
    xt = tvsconv.build_row_tap_stack(torch.from_numpy(x), **geo)
    y_ref = np.asarray(jvsconv.vsconv_dw_stack_pallas(
        jnp.asarray(xt.numpy()), j.vs, w_out=ho, bh=ho, interpret=True,
        **geo, **jkw))
    y = tdw.vsconv_dw_stack_plain(xt, t.vs, w_out=ho, **geo, **tkw)
    _assert_close(y, y_ref)
    before = tdw.vsconv_dw_stack_kernel.launches
    assert torch.equal(tdw.vsconv_dw_stack_kernel(xt, t.vs, w_out=ho, **geo,
                                                  **tkw), y)
    assert tdw.vsconv_dw_stack_kernel.launches == before
    _assert_close(tk.vsconv(torch.from_numpy(x), t.vs, groups=c,
                            impl="stack", **geo, **tkw), y_ref)


def test_stack_costs_match_reference():
    kw = dict(n=8, hop=56, w_out=56, bw=64, bh=8, nb=2, s_steps=5, vk=32,
              vn=128, residual_bytes=11)
    est = jvsconv.stack_kernel_cost(**kw)
    assert tvsconv.stack_kernel_cost(**kw) == {
        "flops": est.flops, "bytes_accessed": est.bytes_accessed}
    kw = dict(n=8, hop=8, w_out=7, bw=16, bh=8, nb=4, s_steps=4, vc=128,
              residual_bytes=3)
    est = jvsconv.dw_stack_kernel_cost(**kw)
    assert tdw.dw_stack_kernel_cost(**kw) == {
        "flops": est.flops, "bytes_accessed": est.bytes_accessed}


def test_stack_geometry_refusals():
    """The wrappers check the planes and every tap's column window against
    the buffer before anything would launch."""
    x = torch.zeros(1, 8, 8, 32)
    t, _ = tg.sparse_conv_from_dense(np.ones((3, 3, 32, 32), np.float32),
                                     1.0)
    xt = tvsconv.build_row_tap_stack(x, kh=3, kw=3, stride=1)
    with pytest.raises(ValueError, match="planes"):
        tvsconv.vsconv_stack_plain(xt, t.vs, w_out=8, kh=3, kw=3, stride=2)
    with pytest.raises(ValueError, match="reads past"):
        tvsconv.vsconv_stack_plain(xt, t.vs, w_out=15, kh=3, kw=3)
    with pytest.raises(ValueError, match="groups"):
        tvsconv.vsconv_stack_plain(xt, t.vs, w_out=8, groups=3)


@pytest.mark.parametrize("build,stem", [
    (tg.build_resnet18, "conv1"),        # 7x7/s2, cin 3 -> 8, vn 64
    (tg.build_mobilenet_v1, "conv0"),    # 3x3/s2, cin 3 -> 8, vn 32
])
def test_stem_rule_picks_exactly_the_stem(build, stem):
    """Over every conv that `sparsify` encodes, `use_stem_body` holds for
    the stem alone: every other layer keeps the generic body (or is
    depthwise or 1x1, which never reach the conv kernels' bodies)."""
    from repro_torch.models.layers import init_params
    net = build(10)
    sparse, _ = tg.sparsify(net, init_params(net.schema(), 0, device="cpu"),
                            0.5)
    picked = []
    for l in net.layers:
        if not isinstance(l, tg.Conv):
            continue
        spec = sparse[l.name]
        c = l.cin + spec.cin_pad
        if tvsconv.use_stem_body(c, spec.vs.vk, spec.groups, spec.kh,
                                 spec.kw, spec.vs.vn, stride=spec.stride,
                                 dilation=spec.dilation):
            picked.append(l.name)
    assert picked == [stem]


@pytest.mark.parametrize("c,vk,groups,kh,kw,vn,stride,want", [
    (8, 8, 1, 7, 7, 64, 2, True),     # the ResNet-18 stem
    (8, 8, 1, 3, 3, 32, 2, True),     # the MobileNetV1 stem
    (16, 8, 1, 3, 3, 64, 1, True),    # two cin tiles
    (32, 32, 1, 3, 3, 64, 1, False),  # tiles by 32: the generic body
    (24, 8, 1, 3, 3, 64, 1, False),   # wider than the window allows
    (8, 8, 1, 1, 1, 64, 1, False),    # 1x1: vsmm
    (8, 8, 2, 3, 3, 64, 1, False),    # grouped
    (8, 8, 1, 3, 3, 16, 1, False),    # vn 16: not 32 or 64
    (16, 8, 1, 11, 11, 64, 4, False),  # a window over the shared memory
])
def test_stem_rule(c, vk, groups, kh, kw, vn, stride, want):
    assert tvsconv.use_stem_body(c, vk, groups, kh, kw, vn,
                                 stride=stride) is want
    if want:
        assert tvsconv.stem_smem_bytes(
            c, vn, kh=kh, kw=kw, stride=stride, dilation=1,
            layout="stack") <= tvsconv.STEM_MAX_SMEM


@pytest.mark.parametrize("n,h_out,c,vc,stride,layout,want", [
    (8, 112, 32, 32, 1, "halo", (8, 16, 256)),   # dw1: 784 blocks
    (8, 56, 64, 64, 2, "halo", (4, 8, 256)),     # dw2: 8 x 8 halved, window
    (8, 28, 128, 128, 2, "halo", (4, 4, 256)),   # dw4
    (8, 7, 1024, 128, 1, "halo", (2, 4, 256)),   # dw13: halved to 512 blocks
    (1, 7, 128, 128, 1, "halo", (1, 1, 256)),    # one image: a pixel a block
    (8, 112, 32, 32, 1, "stack", (1, 32, 128)),  # dw1: one row of 32
    (8, 56, 128, 128, 1, "stack", (1, 8, 128)),  # dw3
    (8, 14, 512, 128, 1, "stack", (1, 14, 128)),  # dw7: the whole row
])
def test_dw_tile(n, h_out, c, vc, stride, layout, want):
    """The depthwise kernels' tile: near the layout's element count, a
    window within DW_WINDOW_BYTES, at least DW_MIN_BLOCKS blocks where
    there are that many pixels."""
    geo = dict(kh=3, kw=3, stride=stride, dilation=1, layout=layout)
    th, tw, threads = tdw.dw_tile(n, h_out, h_out, c, vc, **geo)
    assert (th, tw, threads) == want
    assert tdw.dw_window_bytes(th, tw, vc, **geo) <= tdw.DW_WINDOW_BYTES
