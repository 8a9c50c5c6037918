"""The reference's exported back-compat aliases in the port, each against
the reference on the same inputs, on the CPU: `core.sparse_ops`'s
``im2col_3x3``, ``vs_conv2d_3x3`` and ``dense_conv2d_3x3``,
`kernels.ref`'s ``conv_ref`` and ``conv3x3_ref``, and
`configs.base.uniform_segments`.

A patch copy is bit-equal; a conv is within 1e-5 of max|y| (the order of
the f32 sums); the segments are equal field for field.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import base as jbase
from repro.core import sparse_ops as jops
from repro.core import vector_sparse as jv
from repro.core.pruning import prune_vectors_balanced
from repro.kernels import ref as jref
from repro_torch.configs import base as tbase
from repro_torch.core import sparse_ops as tops
from repro_torch.core import vector_sparse as tv
from repro_torch.kernels import ref as tref

RTOL = 1e-5
CIN, COUT = 32, 64


def _x(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (2, 9, 7, CIN)).astype(np.float32)


def _w(seed: int = 1, groups: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (3, 3, CIN // groups, COUT)).astype(np.float32)


def _vs():
    """The same pruned 3x3 weight, encoded on both sides (density 0.5,
    vk 8, vn 32; the (ky, kx, cin) row order of the patches)."""
    w = _w().reshape(9 * CIN, COUT)
    wp, mask = prune_vectors_balanced(w, 0.5, 8, 32)
    return (jv.from_mask(jnp.asarray(wp), mask, 8, 32),
            tv.from_mask(torch.from_numpy(wp), mask, 8, 32))


def _close(got, want) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= RTOL, err


def _im2col():
    x = _x()
    return jops.im2col_3x3(jnp.asarray(x)), tops.im2col_3x3(
        torch.from_numpy(x)), True


def _vs_conv():
    jw, tw = _vs()
    x = _x()
    return (jops.vs_conv2d_3x3(jnp.asarray(x), jw, impl="jnp"),
            tops.vs_conv2d_3x3(torch.from_numpy(x), tw), False)


def _dense_conv():
    x, w = _x(), _w()
    return (jops.dense_conv2d_3x3(jnp.asarray(x), jnp.asarray(w)),
            tops.dense_conv2d_3x3(torch.from_numpy(x), torch.from_numpy(w)),
            False)


def _conv_ref():
    x, w = _x(), _w(groups=4)
    kw = dict(stride=2, groups=4, dilation=2)
    return (jref.conv_ref(jnp.asarray(x), jnp.asarray(w), **kw),
            tref.conv_ref(torch.from_numpy(x), torch.from_numpy(w), **kw),
            False)


def _conv3x3_ref():
    x, w = _x(), _w()
    return (jref.conv3x3_ref(jnp.asarray(x), jnp.asarray(w)),
            tref.conv3x3_ref(torch.from_numpy(x), torch.from_numpy(w)),
            False)


ALIASES = {"im2col_3x3": _im2col, "vs_conv2d_3x3": _vs_conv,
           "dense_conv2d_3x3": _dense_conv, "conv_ref": _conv_ref,
           "conv3x3_ref": _conv3x3_ref, "uniform_segments": None}


@pytest.mark.parametrize("name", list(ALIASES))
def test_alias_equals_the_reference(name):
    if name == "uniform_segments":
        for n, spec in ((4, ("attn", "mlp", None)),
                        (32, ("rwkv_tm", "rwkv_cm", None)),
                        (3, ("attn", "mlp", 16))):
            want = jbase.uniform_segments(n, jbase.LayerSpec(*spec))
            got = tbase.uniform_segments(n, tbase.LayerSpec(*spec))
            assert [dataclasses.asdict(s) for s in got] == \
                [dataclasses.asdict(s) for s in want]
        return
    want, got, exact = ALIASES[name]()
    assert got.dtype == torch.float32
    if exact:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got.numpy(), want)
    assert name in (tops.__all__ + tref.__all__)
