"""Vector pruning (Mao et al., CVPRW'17 — the paper's reference [18]).

The port of `repro/core/pruning.py`.  Prunes weights at *vector*
granularity: the score of a vector (tile) is its L2 norm; the
lowest-scoring vectors are zeroed until the target density is reached.

* `prune_vectors` — global threshold (exactly Mao et al.; the cycle
  model's and the paper's figures);
* `prune_vectors_balanced` — an equal quota of the highest-scoring tiles
  in every output strip, which is what the balanced block-CSR kernels
  need;
* `prune_conv_columns` — the paper's conv granularity: the kh-column of
  each (kx, cin, cout);
* `prune_tree_balanced` — `prune_vectors_balanced` over every large 2-D
  leaf of a weight tree, with a report of each pruned leaf's density
  keyed by the leaf's path written as the reference's ``keystr``.

Host-side numpy, as in the reference; every function also takes torch
tensors (they are read through numpy, and `prune_tree_balanced` gives a
pruned tensor back in its leaf's dtype and device).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["vector_scores", "prune_vectors", "prune_vectors_balanced",
           "prune_conv_columns", "prune_tree_balanced", "element_density"]


def _numpy(w: Any) -> np.ndarray:
    """A numpy view of ``w`` (a torch tensor is read on the host; a bf16
    one in f32, which numpy lacks)."""
    if isinstance(w, torch.Tensor):
        t = w.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(w)


def element_density(w: Any) -> float:
    w = _numpy(w)
    return float(np.count_nonzero(w)) / w.size


def vector_scores(w: np.ndarray, vk: int, vn: int) -> np.ndarray:
    """(KB, NB) L2 norms of (vk, vn) tiles."""
    w = _numpy(w)
    k, n = w.shape
    t = w.reshape(k // vk, vk, n // vn, vn)
    return np.sqrt((t.astype(np.float64) ** 2).sum(axis=(1, 3)))


def _apply_tile_mask(w: np.ndarray, mask: np.ndarray, vk: int,
                     vn: int) -> np.ndarray:
    m = np.repeat(np.repeat(mask, vk, axis=0), vn, axis=1)
    return (w * m).astype(w.dtype)


def prune_vectors(w: np.ndarray, density: float, vk: int,
                  vn: int) -> np.ndarray:
    """Global magnitude vector pruning to ~`density` fraction of tiles kept."""
    w = _numpy(w)
    scores = vector_scores(w, vk, vn)
    keep = max(1, int(round(scores.size * density)))
    thresh = np.partition(scores.ravel(), scores.size - keep)[
        scores.size - keep]
    mask = scores >= thresh
    return _apply_tile_mask(w, mask, vk, vn)


def prune_vectors_balanced(w: np.ndarray, density: float, vk: int,
                           vn: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-strip equal-quota vector pruning.

    Returns (pruned_dense, mask) where mask is (KB, NB) with identical per-
    column counts — directly encodable by `vector_sparse.from_mask`.
    """
    w = _numpy(w)
    scores = vector_scores(w, vk, vn)  # (KB, NB)
    kb, nb = scores.shape
    s = max(1, int(round(kb * density)))
    order = np.argsort(-scores, axis=0)  # descending per strip
    mask = np.zeros_like(scores, dtype=bool)
    mask[order[:s], np.arange(nb)[None, :]] = True
    return _apply_tile_mask(w, mask, vk, vn), mask


def prune_conv_columns(w: np.ndarray, density: float) -> np.ndarray:
    """Paper-granularity pruning of conv weights (kh, kw, cin, cout).

    Vector = the kh-column for each (kw, cin, cout) — e.g. WA1..WA3 in
    Fig. 6.
    """
    w = _numpy(w)
    scores = np.sqrt((w.astype(np.float64) ** 2).sum(axis=0))  # (kw, cin, cout)
    keep = max(1, int(round(scores.size * density)))
    thresh = np.partition(scores.ravel(), scores.size - keep)[
        scores.size - keep]
    mask = (scores >= thresh)[None]  # broadcast over kh
    return (w * mask).astype(w.dtype)


def prune_tree_balanced(params: Any, density: float, vk: int, vn: int,
                        *, min_dim: int = 256) -> tuple[Any, dict]:
    """Vector-prune every 2-D matmul weight in a tree of dicts, lists and
    tuples (leaves numpy arrays or torch tensors).

    Matrices smaller than `min_dim` on either axis, or not a whole number
    of (vk, vn) tiles, are left as they are, as is every leaf of another
    rank.  Returns (new tree, report): the report maps each pruned leaf's
    path (the reference's ``keystr``: ``['a'][0]``) to its element
    density.
    """
    report: dict = {}

    def visit(leaf: Any, path: str) -> Any:
        if isinstance(leaf, dict):
            return {k: visit(v, f"{path}[{k!r}]") for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(visit(v, f"{path}[{i}]")
                              for i, v in enumerate(leaf))
        if getattr(leaf, "ndim", None) != 2:
            return leaf
        k, n = leaf.shape
        if k < min_dim or n < min_dim or k % vk or n % vn:
            return leaf
        pruned, _ = prune_vectors_balanced(leaf, density, vk, vn)
        report[path] = element_density(pruned)
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(pruned).to(dtype=leaf.dtype,
                                               device=leaf.device)
        return pruned.astype(leaf.dtype)

    return visit(params, ""), report
