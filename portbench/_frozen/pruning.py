"""Balanced vector pruning and the tile geometry it is applied in.

Copied from ``src/repro_torch/core/pruning.py`` (``vector_scores``,
``prune_vectors_balanced``) and ``src/repro_torch/models/graph.py``
(``conv_tile_geometry`` for ungrouped convs, ``fc_tile_geometry``,
``strip_steps``, and `sparsify`'s rule of which convs prune) at commit
cb64fea1c63dc5ff4d7b3fa90baae8ccbbb73fb8.  This is the rule the served
weights follow: an equal quota of the highest-L2 (vk, vn) tiles in every
output strip.  Later changes to the program do not change this copy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Geometry", "conv_geometry", "fc_geometry", "strip_steps",
           "prune_balanced"]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one weight matrix is tiled: (``vk``, ``vn``) tiles, ``cin_pad``
    zero input channels (convs), ``pad`` zero output columns (FCs),
    ``kb`` K-tiles, ``nb`` strips, and whether it is pruned at all."""

    vk: int
    vn: int
    kb: int
    nb: int
    cin_pad: int = 0
    pad: int = 0
    prune: bool = True


def _largest_divisor(n: int, cap: int) -> int:
    d = min(cap, n)
    while n % d:
        d -= 1
    return d


def conv_geometry(kh: int, kw: int, cin: int, cout: int, *, vk: int = 32,
                  vn: int = 128) -> Geometry:
    """An ungrouped conv's geometry.  A cin that does not tile shrinks the
    K-tile to min(vk, 8) and pads the channels to it; the strip is the
    largest divisor of cout <= vn.  A conv of cin < vk (a stem) is not
    pruned."""
    if cin % vk == 0:
        vk_l, cp = vk, 0
    else:
        vk_l = min(vk, 8)
        cp = -cin % vk_l
    vn_l = _largest_divisor(cout, vn)
    return Geometry(vk=vk_l, vn=vn_l, kb=kh * kw * (cin + cp) // vk_l,
                    nb=cout // vn_l, cin_pad=cp, prune=cin >= vk)


def fc_geometry(din: int, dout: int, *, vk: int = 32, vn: int = 128
                ) -> Geometry | None:
    """An FC's geometry, or None where the layer stays dense (fan-in not
    a vk multiple).  A dout that does not tile gets zero pad columns (the
    remainder strip)."""
    if din % vk:
        return None
    vn_l = min(vn, dout)
    pad = -dout % vn_l
    return Geometry(vk=vk, vn=vn_l, kb=din // vk, nb=(dout + pad) // vn_l,
                    pad=pad)


def strip_steps(kb: int, density: float, *, prune: bool = True) -> int:
    """Kept tiles per strip after balanced pruning."""
    if not prune or density >= 1.0:
        return kb
    return max(1, int(round(kb * density)))


def vector_scores(w: np.ndarray, vk: int, vn: int) -> np.ndarray:
    """(KB, NB) L2 norms of (vk, vn) tiles, in float64."""
    k, n = w.shape
    t = w.reshape(k // vk, vk, n // vn, vn)
    return np.sqrt((t.astype(np.float64) ** 2).sum(axis=(1, 3)))


def prune_balanced(w: np.ndarray, density: float, vk: int, vn: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(pruned w, (KB, NB) mask): the ``round(KB * density)`` tiles of
    largest norm in every strip kept, the others zeroed."""
    scores = vector_scores(w, vk, vn)
    kb, nb = scores.shape
    s = max(1, int(round(kb * density)))
    order = np.argsort(-scores, axis=0)
    mask = np.zeros_like(scores, dtype=bool)
    mask[order[:s], np.arange(nb)[None, :]] = True
    m = np.repeat(np.repeat(mask, vk, axis=0), vn, axis=1)
    return (w * m).astype(w.dtype), mask
