"""Public wrappers around the CUDA kernels: layout prep and routing.

Mirrors `repro/kernels/ops.py`:

  * `vsmm` — x (M, K) @ vector-sparse W.  The CUDA kernel masks a ragged
    M, so no row padding is needed;
  * `vsconv` — NHWC kh x kw / stride / dilation / SAME (grouped) conv.
    Ungrouped 1x1 convs route through `vsmm` over flattened pixels (stride
    subsamples first); depthwise convs (groups == C, multiplier 1, the
    (kh*kw, C) tap matrix) run the per-channel tap kernels; every other
    conv runs the full conv kernel with ``groups``.  ``impl`` picks the
    input layout: ``"halo"`` pads once into the halo buffer, ``"stack"``
    materializes the row-tap stack (the oracle/fallback).  The wrapper
    does not round Hout up to a row block (a TPU block constraint).

Both take the reference's ``skip_zero_inputs`` (default True): False
turns the kernels' input-side skip off (the paper's dense-input mode),
with the same output bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_ops import is_depthwise, same_pads
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels.vsconv import (build_halo_input, build_row_tap_stack,
                                        vsconv_halo_kernel,
                                        vsconv_stack_kernel)
from repro_torch.kernels.vsconv_dw import (vsconv_dw_halo_kernel,
                                           vsconv_dw_stack_kernel)
from repro_torch.kernels.vsmm import vsmm_kernel

__all__ = ["vsmm", "vsconv"]


def vsmm(
    x: torch.Tensor,
    vs: VectorSparse,
    *,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    skip_zero_inputs: bool = True,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """x (M, K) @ vector-sparse W (K, N) -> (M, N), epilogue fused:
    ``scale`` (N,) multiply, ``bias`` (N,) add, ``residual`` (M, N) add
    (before the ReLU — the ResNet shortcut), ``fuse_relu``."""
    return vsmm_kernel(x.contiguous(), vs, bias=bias,
                       residual=None if residual is None
                       else residual.contiguous(),
                       scale=scale, fuse_relu=fuse_relu,
                       skip_zero_inputs=skip_zero_inputs)


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
    skip_zero_inputs: bool = True,
    fuse_relu: bool = False,
    impl: str = "halo",
) -> torch.Tensor:
    """NHWC conv with vector-sparse (kh*kw*Cin/groups, Cout) weights
    -> (N, ceil(H/stride), ceil(W/stride), Cout)."""
    if impl not in ("halo", "stack"):
        raise ValueError(f"vsconv impl must be 'halo' or 'stack', "
                         f"got {impl!r}")
    n, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if kh == 1 and kw == 1 and groups == 1:
        if stride != 1:
            x = x[:, ::stride, ::stride]
        _, ho, wo, _ = x.shape
        res2 = (None if residual is None
                else residual.reshape(n * ho * wo, -1))
        out = vsmm(x.reshape(-1, c), vs, bias=bias, residual=res2,
                   scale=scale, skip_zero_inputs=skip_zero_inputs,
                   fuse_relu=fuse_relu)
        return out.reshape(n, ho, wo, -1)
    wo, _, _ = same_pads(w, kw, stride, dilation)
    common = dict(w_out=wo, kh=kh, kw=kw, stride=stride, dilation=dilation,
                  bias=bias, scale=scale, fuse_relu=fuse_relu,
                  skip_zero_inputs=skip_zero_inputs,
                  residual=None if residual is None
                  else residual.contiguous())
    depthwise = is_depthwise(groups, c, vs, kh, kw)
    if impl == "stack":
        xt = build_row_tap_stack(x, kh=kh, kw=kw, stride=stride,
                                 dilation=dilation)
        if depthwise:
            return vsconv_dw_stack_kernel(xt, vs, **common)
        return vsconv_stack_kernel(xt, vs, groups=groups, **common)
    if depthwise:
        xh = build_halo_input(x, kh=kh, kw=kw, stride=stride,
                              dilation=dilation, vk=vs.vn)
        return vsconv_dw_halo_kernel(xh, vs, **common)
    xh = build_halo_input(x, kh=kh, kw=kw, stride=stride, dilation=dilation,
                          vk=vs.vk)
    return vsconv_halo_kernel(xh, vs, groups=groups, **common)
