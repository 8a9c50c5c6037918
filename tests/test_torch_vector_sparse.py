"""The port's weight format and pruning against the JAX reference.

The same numpy weight goes through `repro.core` and `repro_torch.core`;
masks, indices and stored tiles must be identical (no arithmetic happens
in encoding, so equality is exact).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jp
from repro.core import vector_sparse as jv
from repro_torch.core import pruning as tp
from repro_torch.core import vector_sparse as tv

CASES = [  # K, N, vk, vn, density
    (64, 32, 8, 8, 0.5),
    (96, 20, 32, 10, 0.34),     # a 10-wide strip
    (9 * 32, 64, 8, 32, 0.25),  # a 3x3 conv over 32 channels, vk 8
    (512, 1024, 32, 128, 0.235),
]


def _weight(k, n, seed=0):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


@pytest.mark.parametrize("k,n,vk,vn,density", CASES)
def test_pruning_matches_reference(k, n, vk, vn, density):
    w = _weight(k, n)
    np.testing.assert_array_equal(tp.vector_scores(w, vk, vn),
                                  jp.vector_scores(w, vk, vn))
    wp_t, mask_t = tp.prune_vectors_balanced(w, density, vk, vn)
    wp_j, mask_j = jp.prune_vectors_balanced(w, density, vk, vn)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_array_equal(wp_t, wp_j)


@pytest.mark.parametrize("k,n,vk,vn,density", CASES)
def test_encoding_matches_reference(k, n, vk, vn, density):
    wp, mask = jp.prune_vectors_balanced(_weight(k, n, 1), density, vk, vn)
    ref = jv.from_mask(jnp.asarray(wp), mask, vk, vn)
    for vs in (tv.from_mask(torch.from_numpy(wp), mask, vk, vn),
               tv.encode(torch.from_numpy(wp), vk, vn)):
        np.testing.assert_array_equal(vs.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(vs.vals.numpy(), np.asarray(ref.vals))
        assert vs.idx.dtype == torch.int32 and vs.shape == ref.shape
        assert (vs.vk, vs.vn, vs.kb, vs.n_strips, vs.nnz_per_strip) == (
            ref.vk, ref.vn, ref.kb, ref.n_strips, ref.nnz_per_strip)
        assert vs.density == pytest.approx(ref.density)
        np.testing.assert_array_equal(tv.decode(vs).numpy(), wp)
    np.testing.assert_array_equal(
        tv.tile_mask(torch.from_numpy(wp), vk, vn).numpy(),
        np.asarray(jv.tile_mask(jnp.asarray(wp), vk, vn)))


@pytest.mark.parametrize("kh,cin,vk", [(3, 64, 32), (7, 8, 8), (3, 32, 8)])
def test_conv_cin_major_matches_reference(kh, cin, vk):
    """The cin-major reorder permutes each strip exactly as the reference
    does, and decodes back to the same matrix."""
    k, n, vn = kh * kh * cin, 64, 32
    wp, mask = jp.prune_vectors_balanced(_weight(k, n, 2), 0.4, vk, vn)
    ref = jv.conv_cin_major(jv.from_mask(jnp.asarray(wp), mask, vk, vn),
                            cin // vk)
    vs = tv.conv_cin_major(tv.from_mask(torch.from_numpy(wp), mask, vk, vn),
                           cin // vk)
    np.testing.assert_array_equal(vs.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(vs.vals.numpy(), np.asarray(ref.vals))
    np.testing.assert_array_equal(tv.decode(vs).numpy(),
                                  np.asarray(jv.decode(ref)))


def test_unbalanced_or_mismatched_mask_raises():
    w = torch.ones(16, 16)
    mask = np.zeros((2, 2), bool)
    mask[0, 0] = mask[1, 0] = mask[0, 1] = True
    with pytest.raises(ValueError, match="unbalanced"):
        tv.from_mask(w, mask, 8, 8)
    with pytest.raises(ValueError, match="does not match"):
        tv.from_mask(w, np.ones((4, 2), bool), 8, 8)
    with pytest.raises(ValueError, match="not tileable"):
        tv.tile_mask(torch.ones(10, 16), 8, 8)
