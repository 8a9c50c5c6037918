"""Vector pruning (Mao et al., CVPRW'17 — the paper's reference [18]).

The score of a (vk, vn) tile is its L2 norm.  `prune_vectors_balanced`
keeps an equal quota of the highest-scoring tiles in every output strip,
which is what the balanced block-CSR kernels need.  Host-side numpy, as in
the reference.
"""
from __future__ import annotations

import numpy as np

__all__ = ["vector_scores", "prune_vectors_balanced"]


def vector_scores(w: np.ndarray, vk: int, vn: int) -> np.ndarray:
    """(KB, NB) L2 norms of (vk, vn) tiles."""
    k, n = w.shape
    t = w.reshape(k // vk, vk, n // vn, vn)
    return np.sqrt((t.astype(np.float64) ** 2).sum(axis=(1, 3)))


def _apply_tile_mask(w: np.ndarray, mask: np.ndarray, vk: int,
                     vn: int) -> np.ndarray:
    m = np.repeat(np.repeat(mask, vk, axis=0), vn, axis=1)
    return (w * m).astype(w.dtype)


def prune_vectors_balanced(w: np.ndarray, density: float, vk: int,
                           vn: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-strip equal-quota vector pruning.

    Returns (pruned_dense, mask) where mask is (KB, NB) with identical per-
    column counts — directly encodable by `vector_sparse.from_mask`.
    """
    w = np.asarray(w)
    scores = vector_scores(w, vk, vn)  # (KB, NB)
    kb, nb = scores.shape
    s = max(1, int(round(kb * density)))
    order = np.argsort(-scores, axis=0)  # descending per strip
    mask = np.zeros_like(scores, dtype=bool)
    mask[order[:s], np.arange(nb)[None, :]] = True
    return _apply_tile_mask(w, mask, vk, vn), mask
