"""The weights bridge: load the JAX package's weights into the port.

Both sides then compute with the same numbers.  Nothing here imports the
JAX package: the inputs are nested dicts of array-likes (numpy arrays, or
anything `numpy.asarray` accepts), and a `sparsify` result's entries are
read by attribute, so any object with the reference's `SparseConv` /
`SparseFC` fields works.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.models.graph import SparseConv, SparseFC

__all__ = ["params_from_numpy", "sparse_from_numpy"]


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX hands out ml_dtypes'), and
        # torch.from_numpy refuses it: carry the bits over as uint16
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Any, device: str | torch.device | None = None
                      ) -> Any:
    """A nested dict / list of arrays (the reference's ``init_params``
    tree; an LM tree's ``segments`` is a list) -> the same nesting of
    tensors on ``device`` (CUDA by default).  f32, bfloat16 and int32
    arrays keep their dtype and bits: a vector-sparse FFN's tree (its
    ``wi_vals`` / ``wo_vals`` tiles with their leading (gate, up) and tp
    dims, int32 ``wi_idx`` / ``wo_idx``) and an embedding-input arch's
    (no ``embed``) come across as they are."""
    dev = resolve_device(device)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return _tensor(node, dev)

    return walk(tree)


def sparse_from_numpy(sparse: dict, device: str | torch.device | None = None
                      ) -> dict:
    """A reference `sparsify` result {name: SparseConv | SparseFC} -> the
    port's entries on ``device`` (CUDA by default).  An entry with conv
    geometry (``kh``) becomes a `SparseConv`, any other a `SparseFC`."""
    dev = resolve_device(device)

    def opt(a: Any) -> torch.Tensor | None:
        return None if a is None else _tensor(a, dev)

    out: dict = {}
    for name, e in sparse.items():
        vs = VectorSparse(vals=_tensor(e.vs.vals, dev),
                          idx=_tensor(e.vs.idx, dev).to(torch.int32),
                          shape=tuple(int(d) for d in e.vs.shape))
        if hasattr(e, "kh"):
            out[name] = SparseConv(
                vs, kh=e.kh, kw=e.kw, stride=e.stride, groups=e.groups,
                dilation=e.dilation, cin_pad=e.cin_pad, bias=opt(e.bias),
                scale=opt(e.scale))
        else:
            out[name] = SparseFC(vs, dout=e.dout, bias=opt(e.bias),
                                 scale=opt(e.scale))
    return out
