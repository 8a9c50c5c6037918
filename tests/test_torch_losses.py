"""The port's chunked cross-entropy against the reference's, values and
gradients, on the CPU (no mesh: the reference's `logical` is then the
identity).

Cases: a chunk that divides T and one that does not (the last chunk
zero-padded and masked), a padded vocabulary (its columns masked to
-1e30), the z-loss, a token mask; `cross_entropy_dense`.  f32 within
1e-5 relative: the loss, and the gradients with respect to h and to the
unembedding (the max is held out of the gradient on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import losses as RL
from repro_torch.parallel import losses as TL

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("t,chunk,vocab,vp,z,masked", [
    (32, 8, 100, 100, 0.0, False),
    (30, 8, 100, 128, 1e-4, False),
    (24, 64, 90, 96, 0.0, True),
    (20, 6, 64, 64, 1e-4, True),
])
def test_chunked_cross_entropy_matches_reference(t, chunk, vocab, vp, z,
                                                 masked):
    rng = np.random.default_rng(t + chunk)
    b, d = 3, 16
    h = rng.standard_normal((b, t, d)).astype(np.float32)
    w = (rng.standard_normal((d, vp)) / 4).astype(np.float32)
    labels = rng.integers(0, vocab, (b, t)).astype(np.int32)
    mask = rng.random((b, t)) > 0.3 if masked else None
    kw = dict(real_vocab=vocab, chunk=chunk, z_weight=z)

    def ref(h_, w_):
        return RL.chunked_cross_entropy(
            h_, jnp.asarray(labels), w_,
            mask=None if mask is None else jnp.asarray(mask), **kw)

    loss, (gh, gw) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ht, wt = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    lt = TL.chunked_cross_entropy(
        ht, torch.from_numpy(labels), wt,
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert lt.dtype == torch.float32 and lt.ndim == 0
    assert _rel(float(lt), float(loss)) <= RTOL
    th, tw = torch.autograd.grad(lt, (ht, wt))
    assert _rel(th, gh) <= RTOL and _rel(tw, gw) <= RTOL


def test_cross_entropy_dense_matches_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((6, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    ref = RL.cross_entropy_dense(jnp.asarray(logits), jnp.asarray(labels))
    port = TL.cross_entropy_dense(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    assert _rel(float(port), float(ref)) <= RTOL


def test_bf16_inputs_sum_in_f32():
    """bf16 h and unembedding (the card's training dtype): the product is
    taken in f32, so the loss equals the f32 copies' loss."""
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((2, 12, 16)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((16, 40)).astype(
        np.float32)).bfloat16()
    labels = torch.from_numpy(rng.integers(0, 33, (2, 12)))
    a = TL.chunked_cross_entropy(h, labels, w, real_vocab=33, chunk=5)
    b = TL.chunked_cross_entropy(h.float(), labels, w.float(),
                                 real_vocab=33, chunk=5)
    assert a.dtype == torch.float32 and torch.equal(a, b)
