"""Public wrappers around the CUDA kernels: layout prep and routing.

Mirrors `repro/kernels/ops.py`:

  * `vsmm` — x (M, K) @ vector-sparse W.  The CUDA kernel masks a ragged
    M, so no row padding is needed;
  * `vsconv` — NHWC kh x kw / stride / dilation / SAME conv.  Ungrouped
    1x1 convs route through `vsmm` over flattened pixels (stride
    subsamples first); every other ungrouped conv pads once into the halo
    layout and runs the direct halo kernel.  The wrapper does not round
    Hout up to a row block (that padding is a TPU block constraint).

Grouped and depthwise convs (the per-channel tap kernels) and the row-tap
stack layout are ported in later slices and raise here.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_ops import same_pads
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels.vsconv import build_halo_input, vsconv_halo_kernel
from repro_torch.kernels.vsmm import vsmm_kernel

__all__ = ["vsmm", "vsconv"]


def vsmm(
    x: torch.Tensor,
    vs: VectorSparse,
    *,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """x (M, K) @ vector-sparse W (K, N) -> (M, N), epilogue fused:
    ``scale`` (N,) multiply, ``bias`` (N,) add, ``residual`` (M, N) add
    (before the ReLU — the ResNet shortcut), ``fuse_relu``."""
    return vsmm_kernel(x.contiguous(), vs, bias=bias,
                       residual=None if residual is None
                       else residual.contiguous(),
                       scale=scale, fuse_relu=fuse_relu)


def vsconv(
    x: torch.Tensor,
    vs: VectorSparse,
    *,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    groups: int = 1,
    dilation: int = 1,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """NHWC conv with vector-sparse (kh*kw*Cin, Cout) weights
    -> (N, ceil(H/stride), ceil(W/stride), Cout)."""
    if groups != 1:
        raise NotImplementedError(
            "grouped and depthwise conv kernels are ported in a later slice "
            "(MobileNetV1: vsconv_dw_halo_pallas)")
    n, h, w, c = x.shape
    if kh == 1 and kw == 1:
        if stride != 1:
            x = x[:, ::stride, ::stride]
        _, ho, wo, _ = x.shape
        res2 = (None if residual is None
                else residual.reshape(n * ho * wo, -1))
        out = vsmm(x.reshape(-1, c), vs, bias=bias, residual=res2,
                   scale=scale, fuse_relu=fuse_relu)
        return out.reshape(n, ho, wo, -1)
    wo, _, _ = same_pads(w, kw, stride, dilation)
    xh = build_halo_input(x, kh=kh, kw=kw, stride=stride, dilation=dilation,
                          vk=vs.vk)
    return vsconv_halo_kernel(
        xh, vs, w_out=wo, kh=kh, kw=kw, stride=stride, dilation=dilation,
        bias=bias, scale=scale, fuse_relu=fuse_relu,
        residual=None if residual is None else residual.contiguous())
