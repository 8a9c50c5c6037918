"""VectorSparse: the balanced block-CSR weight format (vector sparsity).

A weight matrix W (K, N) is cut into KB x NB tiles of (vk, vn); an all-zero
tile is not stored.  Every output strip (column of tiles) keeps the same
number S of stored K-tiles, so a sparse product is a static-shape gather.
``idx[j, s]`` names the K-tile that the s-th stored tile of strip j
multiplies against — the paper's index system.

Index building is host-side numpy, as in the reference: the index
structure is static data.  The tiles stay on the weight's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["VectorSparse", "encode", "decode", "from_mask", "tile_mask",
           "conv_cin_major"]


@dataclasses.dataclass
class VectorSparse:
    """Balanced block-CSR matrix.

    vals : (NB, S, vk, vn)  -- stored tiles, per output strip
    idx  : (NB, S) int32    -- K-tile index of each stored tile
    shape: (K, N) dense shape
    """

    vals: torch.Tensor
    idx: torch.Tensor
    shape: tuple[int, int]

    @property
    def vk(self) -> int:
        return self.vals.shape[2]

    @property
    def vn(self) -> int:
        return self.vals.shape[3]

    @property
    def nnz_per_strip(self) -> int:
        return self.vals.shape[1]

    @property
    def n_strips(self) -> int:
        return self.vals.shape[0]

    @property
    def kb(self) -> int:
        return self.shape[0] // self.vk

    @property
    def density(self) -> float:
        """Fraction of K-tiles stored (== vector density of the paper)."""
        return self.nnz_per_strip / self.kb

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def astype(self, dtype: torch.dtype) -> VectorSparse:
        """The same matrix with its stored tiles cast to ``dtype``."""
        return VectorSparse(self.vals.to(dtype), self.idx, self.shape)


def tile_mask(w: torch.Tensor, vk: int, vn: int) -> torch.Tensor:
    """(KB, NB) bool mask: True where the (vk, vn) tile of w has any nonzero."""
    k, n = w.shape
    if k % vk or n % vn:
        raise ValueError(f"{tuple(w.shape)} not tileable by ({vk},{vn})")
    return (w.reshape(k // vk, vk, n // vn, vn) != 0).any(dim=3).any(dim=1)


def from_mask(w: torch.Tensor | np.ndarray, mask: np.ndarray, vk: int,
              vn: int) -> VectorSparse:
    """Encode w keeping exactly the tiles where mask is True.

    ``mask`` must be balanced: equal count per column (output strip).  The
    index is built host-side; ``vals`` and ``idx`` land on w's device.
    """
    w = torch.as_tensor(w)
    mask = np.asarray(mask)
    k, n = w.shape
    kb, nb = k // vk, n // vn
    if mask.shape != (kb, nb):
        raise ValueError(f"mask {mask.shape} does not match ({kb}, {nb})")
    counts = mask.sum(axis=0)
    if not np.all(counts == counts[0]):
        raise ValueError(f"unbalanced mask: per-strip counts {counts}")
    # idx[j, s] = ascending K-tile ids of the stored tiles of strip j
    idx = np.stack([np.nonzero(mask[:, j])[0] for j in range(nb)]
                   ).astype(np.int32)
    tiles = w.reshape(kb, vk, nb, vn).permute(2, 0, 1, 3)  # (NB, KB, vk, vn)
    idx_t = torch.as_tensor(idx, device=w.device)
    vals = torch.take_along_dim(tiles, idx_t.long()[:, :, None, None], dim=1)
    return VectorSparse(vals=vals.contiguous(), idx=idx_t, shape=(k, n))


def encode(w: torch.Tensor, vk: int, vn: int) -> VectorSparse:
    """Encode an already vector-pruned dense matrix (balanced occupancy)."""
    return from_mask(w, tile_mask(w, vk, vn).cpu().numpy(), vk, vn)


def conv_cin_major(vs: VectorSparse, cb: int) -> VectorSparse:
    """Reorder each strip's stored tiles cin-tile-major (tap-minor).

    A conv weight's K-tile id is ``t = tap * cb + cin_tile`` (tap-major),
    the ascending order `from_mask` emits.  Issuing the tiles as
    ``(cin_tile, tap)`` lets consecutive steps reuse one input window; it is
    a pure per-strip permutation, so the sum is the same set of products.
    The kernels decode each stored id as given and assume no order.
    """
    idx = vs.idx.cpu().numpy()
    taps = vs.kb // cb
    order = np.argsort((idx % cb) * taps + idx // cb, axis=1, kind="stable")
    order_t = torch.as_tensor(order, device=vs.vals.device)
    vals = torch.take_along_dim(vs.vals, order_t[:, :, None, None], dim=1)
    new_idx = np.take_along_axis(idx, order, axis=1)
    return VectorSparse(vals=vals.contiguous(),
                        idx=torch.as_tensor(new_idx, device=vs.idx.device),
                        shape=vs.shape)


def decode(vs: VectorSparse) -> torch.Tensor:
    """Densify (oracle/debug path)."""
    nb, _, vk, vn = vs.vals.shape
    kb = vs.shape[0] // vk
    tiles = torch.zeros((nb, kb, vk, vn), dtype=vs.vals.dtype,
                        device=vs.vals.device)
    rows = torch.arange(nb, device=vs.vals.device)[:, None]
    tiles.index_put_((rows, vs.idx.long()), vs.vals, accumulate=True)
    return tiles.permute(1, 2, 0, 3).reshape(vs.shape)
