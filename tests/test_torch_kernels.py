"""The port's kernel modules against the JAX reference, on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, so this
holds the plain versions (and the dispatch, layouts and epilogues around
them) against the reference: the Pallas vsmm kernel in interpret mode, the
structural ``impl="jnp"`` path and `kernels/ref.py`.  The halo Pallas
kernel is not an oracle here (it needs `pl.Unblocked`, which this jax
lacks).  The CUDA kernels themselves are held against the same plain
versions on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).

Tolerance: relative 1e-5 of max|y| — the only difference is the order of
the f32 sums.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse_ops as jops
from repro.core import vector_sparse as jv
from repro.core.pruning import prune_vectors_balanced
from repro.kernels import ops as jk
from repro.kernels import ref as jref
from repro_torch.core import sparse_ops as tops
from repro_torch.core import vector_sparse as tv
from repro_torch.kernels import ops as tk
from repro_torch.kernels import ref as tref
from repro_torch.kernels import vsconv as tvsconv
from repro_torch.kernels import vsmm as tvsmm

# the reference package re-exports functions under its submodules' names
jvsconv = importlib.import_module("repro.kernels.vsconv")
jvsmm = importlib.import_module("repro.kernels.vsmm")

RTOL = 1e-5


def _assert_close(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    assert y.shape == ref.shape
    err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= RTOL, err


def _pair(k, n, vk, vn, density, seed):
    """The same encoded weight on both sides."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    wp, mask = prune_vectors_balanced(w, density, vk, vn)
    return (jv.from_mask(jnp.asarray(wp), mask, vk, vn),
            tv.from_mask(torch.from_numpy(wp), mask, vk, vn))


def _act(shape, seed):
    """Post-ReLU-like activations with a zero run (input-side skip)."""
    x = np.maximum(np.random.default_rng(seed).standard_normal(shape), 0)
    x[..., : shape[-1] // 4] = 0
    return x.astype(np.float32)


def _epilogue(epi, n, out_shape, seed):
    if not epi:
        return {}, {}
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n).astype(np.float32)
    r = rng.standard_normal(out_shape).astype(np.float32)
    return (dict(bias=jnp.asarray(b), residual=jnp.asarray(r),
                 fuse_relu=True),
            dict(bias=torch.from_numpy(b), residual=torch.from_numpy(r),
                 fuse_relu=True))


@pytest.mark.parametrize("m,k,n,vk,vn", [
    (37, 64, 20, 8, 10),      # M not a multiple of bm; vn = 10
    (40, 128, 256, 32, 128),
])
@pytest.mark.parametrize("epi", [False, True])
def test_vsmm_matches_reference(m, k, n, vk, vn, epi):
    js, ts = _pair(k, n, vk, vn, 0.5, m)
    x = _act((m, k), k)
    jkw, tkw = _epilogue(epi, n, (m, n), n)
    y_pallas = np.asarray(jk.vsmm(jnp.asarray(x), js, **jkw))
    y_jnp = np.asarray(jops.vs_matmul(jnp.asarray(x), js, impl="jnp", **jkw))
    xt = torch.from_numpy(x)
    for y in (tvsmm.vsmm_plain(xt, ts, **tkw), tk.vsmm(xt, ts, **tkw),
              tops.vs_matmul(xt, ts, impl="plain", **tkw)):
        _assert_close(y, y_pallas)
        _assert_close(y, y_jnp)
    _assert_close(tref.vsmm_ref(xt, ts, **tkw),
                  np.asarray(jref.vsmm_ref(jnp.asarray(x), js, **jkw)))


CONV_CASES = [  # H, cin (after padding), cout, kh, stride, vk, vn, cin_pad
    (32, 8, 64, 7, 2, 8, 64, 5),    # the stem: 3 channels padded to 8
    (12, 64, 64, 3, 1, 32, 64, 0),
    (12, 64, 128, 3, 2, 32, 128, 0),
    (3, 128, 128, 3, 1, 32, 128, 0),  # Hout < 4 (the resident body)
    (12, 64, 128, 1, 2, 32, 128, 0),  # 1x1/s2 -> routed to vsmm
]


@pytest.mark.parametrize("h,cin,cout,kh,stride,vk,vn,cin_pad", CONV_CASES)
@pytest.mark.parametrize("epi", [False, True])
def test_vsconv_matches_reference(h, cin, cout, kh, stride, vk, vn, cin_pad,
                                  epi):
    js, ts = _pair(kh * kh * cin, cout, vk, vn, 0.5, h + kh)
    if kh > 1:
        js = jv.conv_cin_major(js, cin // vk)
        ts = tv.conv_cin_major(ts, cin // vk)
    x = _act((2, h, h, cin), cin)
    if cin_pad:
        x[..., cin - cin_pad:] = 0
    ho = -(-h // stride)
    jkw, tkw = _epilogue(epi, cout, (2, ho, ho, cout), cout)
    geo = dict(kh=kh, kw=kh, stride=stride)
    y_jnp = np.asarray(jops.vs_conv2d(jnp.asarray(x), js, impl="jnp",
                                      **geo, **jkw))
    y_ref = np.asarray(jref.vsconv_ref(jnp.asarray(x), js, **geo, **jkw))
    xt = torch.from_numpy(x)
    for y in (tk.vsconv(xt, ts, **geo, **tkw),
              tops.vs_conv2d(xt, ts, impl="plain", **geo, **tkw),
              tops.vs_conv2d(xt, ts, impl="pallas", **geo, **tkw),
              tref.vsconv_ref(xt, ts, **geo, **tkw)):
        _assert_close(y, y_jnp)
        _assert_close(y, y_ref)
    if kh > 1:  # the plain version of the halo kernel, on the halo buffer
        xh = tvsconv.build_halo_input(xt, **geo, vk=vk)
        _assert_close(tvsconv.vsconv_plain(xh, ts, w_out=ho, **geo, **tkw),
                      y_jnp)


HALO_GEOMETRIES = [  # H, W, kh, kw, stride, dilation, vk, h_out
    (224, 224, 7, 7, 2, 1, 8, None),
    (56, 56, 3, 3, 2, 1, 32, None),
    (7, 7, 3, 3, 1, 1, 32, None),
    (13, 9, 3, 5, 2, 2, 8, None),
    (10, 10, 3, 3, 1, 1, 8, 16),   # Hout rounded up to a row block
]


@pytest.mark.parametrize("h,w,kh,kw,stride,dil,vk,h_out", HALO_GEOMETRIES)
def test_halo_layout_byte_equal(h, w, kh, kw, stride, dil, vk, h_out):
    ho = h_out or -(-h // stride)
    assert tvsconv.halo_layout_dims(
        h, w, kh=kh, kw=kw, stride=stride, dilation=dil, h_out=ho
    ) == jvsconv.halo_layout_dims(h, w, kh=kh, kw=kw, stride=stride,
                                  dilation=dil, h_out=ho)
    x = np.random.default_rng(h * w).standard_normal(
        (2, h, w, 2 * vk)).astype(np.float32)
    kw_ = dict(kh=kh, kw=kw, stride=stride, dilation=dil, vk=vk, h_out=h_out)
    ours = tvsconv.build_halo_input(torch.from_numpy(x), **kw_).numpy()
    theirs = np.asarray(jvsconv.build_halo_input(jnp.asarray(x), **kw_))
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert ours.tobytes() == theirs.tobytes()


def test_costs_and_geometry_helpers_match_reference():
    for size in range(1, 30):
        for k in (1, 3, 7):
            for s in (1, 2):
                for d in (1, 2):
                    assert tops.same_pads(size, k, s, d) == \
                        jops.same_pads(size, k, s, d)
    kw = dict(m=40, nb=8, s_steps=4, vk=32, vn=128, residual_bytes=123)
    est = jvsmm.vsmm_kernel_cost(**kw)
    assert tvsmm.vsmm_kernel_cost(**kw) == {
        "flops": est.flops, "bytes_accessed": est.bytes_accessed}
    for resident in (False, True):
        kw = dict(n=8, hop=8, w_out=7, kh=3, stride=1, bwp=16, bh=8, nb=4,
                  s_steps=34, cb=16, vk=32, vn=128, resident=resident)
        est = jvsconv.halo_kernel_cost(**kw)
        assert tvsconv.halo_kernel_cost(**kw) == {
            "flops": est.flops, "bytes_accessed": est.bytes_accessed}
    for h in range(1, 8):
        for g in (1, 2):
            assert tvsconv.use_resident_halo(h, g) == \
                jvsconv.use_resident_halo(h, g)
    assert tvsconv.RESIDENT_MAX_H == jvsconv.RESIDENT_MAX_H


@pytest.mark.parametrize("stride,groups,dil", [(1, 1, 1), (2, 1, 1),
                                               (1, 4, 2)])
def test_dense_conv_oracle_matches_reference(stride, groups, dil):
    rng = np.random.default_rng(stride + groups)
    x = rng.standard_normal((2, 11, 9, 16)).astype(np.float32)
    w = rng.standard_normal((3, 3, 16 // groups, 8)).astype(np.float32)
    _assert_close(
        tops.dense_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          stride=stride, groups=groups, dilation=dil),
        jops.dense_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                          groups=groups, dilation=dil))


def test_cpu_wrappers_run_plain_and_count_no_launch():
    _, ts = _pair(64, 64, 32, 64, 0.5, 0)
    x = torch.from_numpy(_act((5, 64), 1))
    before = tvsmm.vsmm_kernel.launches, tvsconv.vsconv_halo_kernel.launches
    assert torch.equal(tvsmm.vsmm_kernel(x, ts), tvsmm.vsmm_plain(x, ts))
    xh = tvsconv.build_halo_input(torch.zeros(1, 4, 4, 64), vk=32)
    _, tc = _pair(9 * 64, 64, 32, 64, 0.5, 1)
    assert torch.equal(tvsconv.vsconv_halo_kernel(xh, tc, w_out=4),
                       tvsconv.vsconv_plain(xh, tc, w_out=4))
    assert (tvsmm.vsmm_kernel.launches,
            tvsconv.vsconv_halo_kernel.launches) == before


def test_dispatch_vocabulary_and_unported_paths():
    """The paths once left unported now run: ``pallas-stack``
    and grouped convs agree with the plain path and the dense oracle."""
    _, ts = _pair(9 * 64, 64, 32, 64, 0.5, 0)
    x = torch.from_numpy(_act((1, 4, 4, 64), 2))
    y = tops.vs_conv2d(x, ts, impl="plain")
    _assert_close(tops.vs_conv2d(x, ts, impl="pallas-stack"), y)
    _, tg2 = _pair(9 * 32, 64, 32, 32, 0.5, 1)  # groups=2: 2 strips of 32
    y2 = tops.vs_conv2d(x, tg2, groups=2, impl="plain")
    for impl in ("halo", "stack"):
        _assert_close(tk.vsconv(x, tg2, groups=2, impl=impl), y2)
    _assert_close(y2, tref.vsconv_ref(x, tg2, groups=2))
    with pytest.raises(ValueError, match="unknown impl"):
        tops.vs_conv2d(x, ts, impl="triton")
    with pytest.raises(ValueError, match="impl must be"):
        tk.vsconv(x, ts, impl="pallas")
    with pytest.raises(ValueError, match="does not match"):
        tvsconv.vsconv_halo_kernel(
            tvsconv.build_halo_input(x, vk=32), ts, w_out=4, kh=5, kw=5)
