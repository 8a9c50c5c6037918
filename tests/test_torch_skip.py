"""The kernels' dense-input mode (``skip_zero_inputs=False``) through the
port's dispatch layer, against the reference.

The flag is the reference's: on, a kernel skips the MACs of an all-zero
activation tile (the paper's input-side skip); off, it runs every stored
step, as a dense-issue accelerator does.  A skipped step adds exact zeros,
so the output is the same either way.  On the CPU every wrapper runs its
plain version, which never skips; these tests hold that the flag reaches
every entry point (`ops.vsmm`, `ops.vsconv` over both layouts, full and
depthwise, and `sparse_ops.vs_matmul`), that off equals on, and that off
equals the reference with the flag off:

* vsmm and `vs_matmul`: the reference's `vsmm_pallas` in interpret mode;
* the stack convs: its `vsconv_pallas` / `vsconv_dw_stack_pallas` in
  interpret mode (through its `kernels.ops.vsconv(impl="stack")`);
* the halo convs: its ``vs_conv2d(impl="jnp")`` (its halo Pallas kernels
  need `pl.Unblocked`, which this jax lacks).

Inputs are post-ReLU with whole zero tiles (an all-zero first image, a
zero run of channels).  Tolerance: relative 1e-5 of max|y| in f32 (the
order of the f32 sums), bit for bit in int8.
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
from repro_torch.kernels import ops as tk

RTOL = 1e-5


def _assert_close(y, ref, dtype):
    y, ref = np.asarray(y), np.asarray(ref)
    assert y.shape == ref.shape
    if dtype == "int8":
        assert_array_equal(y, ref)
        return
    err = np.abs(y.astype(np.float64) - ref).max() / max(
        np.abs(ref).max(), 1e-30)
    assert err <= RTOL, err


def _pair(k, n, vk, vn, seed, dtype, *, cb=None):
    """(reference weight, port weight, combined-scale factor): the same
    pruned weight on both sides, int8-quantized for ``dtype="int8"``."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)
    wp, mask = prune_vectors_balanced(w, 0.5, vk, vn)
    s = None
    if dtype == "int8":
        s = jg.weight_scales(wp)
        wp = jg.quantize_weights_int8(wp, s)
    jvs = jv.from_mask(jnp.asarray(wp), mask, vk, vn)
    tvs = tv.from_mask(torch.from_numpy(wp), mask, vk, vn)
    if cb is not None:
        jvs, tvs = jv.conv_cin_major(jvs, cb), tv.conv_cin_major(tvs, cb)
    return jvs, tvs, s


def _input(shape, seed, dtype):
    """(x, activation scale or None): post-ReLU, first quarter of the
    channels zero and, for an image batch, the first image all zero."""
    x = np.maximum(np.random.default_rng(seed).standard_normal(shape), 0)
    x[..., : shape[-1] // 4] = 0
    x[0] = 0
    x = x.astype(np.float32)
    if dtype != "int8":
        return x, None
    xq, sx = jg.quantize_activations_int8(jnp.asarray(x))
    return np.array(xq), np.array(sx)


def _epilogue(n, out_shape, seed, scale):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n).astype(np.float32)
    r = rng.standard_normal(out_shape).astype(np.float32)
    j = dict(bias=jnp.asarray(b), residual=jnp.asarray(r), fuse_relu=True)
    t = dict(bias=torch.from_numpy(b), residual=torch.from_numpy(r),
             fuse_relu=True)
    if scale is not None:
        j["scale"] = jnp.asarray(scale)
        t["scale"] = torch.from_numpy(scale)
    return j, t


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("entry", ["ops.vsmm", "vs_matmul"])
def test_matmul_skip_off_equals_on_and_reference(entry, dtype):
    jvs, tvs, s_w = _pair(128, 256, 32, 128, 1, dtype)
    x, sx = _input((40, 128), 2, dtype)
    scale = None if s_w is None else (sx * s_w).astype(np.float32)
    jkw, tkw = _epilogue(256, (40, 256), 3, scale)
    ref = np.asarray(jk.vsmm(jnp.asarray(x), jvs, skip_zero_inputs=False,
                             **jkw))  # Pallas, interpret mode
    if entry == "vs_matmul":
        ref_jnp = np.asarray(jops.vs_matmul(
            jnp.asarray(x), jvs, impl="pallas", skip_zero_inputs=False,
            **jkw))
        _assert_close(ref_jnp, ref, dtype)
        fn = lambda **kw: tops.vs_matmul(torch.from_numpy(x), tvs,  # noqa
                                         impl="pallas", **tkw, **kw)
    else:
        fn = lambda **kw: tk.vsmm(torch.from_numpy(x), tvs,  # noqa: E731
                                  **tkw, **kw)
    off = fn(skip_zero_inputs=False)
    assert torch.equal(off, fn()) and torch.equal(off,
                                                  fn(skip_zero_inputs=True))
    _assert_close(off.numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("layout", ["halo", "stack"])
@pytest.mark.parametrize("depthwise", [False, True])
def test_conv_skip_off_equals_on_and_reference(layout, depthwise, dtype):
    """A 3x3/s2 conv 64 -> 128 (cin tiles of 32) or a 3x3/s2 depthwise
    conv over 64 channels, 10 px, batch 2, epilogue fused."""
    c, h, stride = 64, 10, 2
    ho = -(-h // stride)
    if depthwise:
        jvs, tvs, s_w = _pair(9, c, 1, 64, 4, dtype)
        groups, cout = c, c
    else:
        jvs, tvs, s_w = _pair(9 * c, 128, 32, 128, 4, dtype, cb=c // 32)
        groups, cout = 1, 128
    x, sx = _input((2, h, h, c), 5, dtype)
    scale = None if s_w is None else (sx * s_w).astype(np.float32)
    jkw, tkw = _epilogue(cout, (2, ho, ho, cout), 6, scale)
    geo = dict(kh=3, kw=3, stride=stride, groups=groups)
    if layout == "stack":  # the reference's stack kernels, interpret mode
        ref = np.asarray(jk.vsconv(jnp.asarray(x), jvs, impl="stack",
                                   skip_zero_inputs=False, interpret=True,
                                   **geo, **jkw))
    else:                  # its halo kernels do not run on this jax
        ref = np.asarray(jops.vs_conv2d(jnp.asarray(x), jvs, impl="jnp",
                                        **geo, **jkw))
    xt = torch.from_numpy(x)
    off = tk.vsconv(xt, tvs, impl=layout, skip_zero_inputs=False, **geo,
                    **tkw)
    assert torch.equal(off, tk.vsconv(xt, tvs, impl=layout, **geo, **tkw))
    _assert_close(off.numpy(), ref, dtype)
