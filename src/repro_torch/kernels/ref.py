"""Dense oracles for the kernels: densify the weight, then dense compute.

These compute the same function as `vsmm` / `vsconv` with plain dense
PyTorch ops.  They are test oracles and `chip_smoke.py` yardsticks only;
the port's own path never calls them.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_ops import dense_conv2d
from repro_torch.core.vector_sparse import VectorSparse, decode

__all__ = ["vsmm_ref", "vsconv_ref", "conv_ref", "conv3x3_ref"]


def _epilogue(y: torch.Tensor, bias: torch.Tensor | None,
              residual: torch.Tensor | None, fuse_relu: bool) -> torch.Tensor:
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    if fuse_relu:
        y = torch.clamp_min(y, 0.0)
    return y


def vsmm_ref(
    x: torch.Tensor,
    vs: VectorSparse,
    *,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """x (M, K) @ densify(vs) (K, N) -> (M, N) in f32, epilogue after."""
    y = x.float() @ decode(vs).float()
    return _epilogue(y, bias, residual, fuse_relu).to(x.dtype)


def conv_ref(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
             groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """Dense kh x kw / stride / dilation / SAME conv oracle in f32, cast
    back to x's dtype: x NHWC, w (kh, kw, Cin/groups, Cout)."""
    return dense_conv2d(x.float(), w.float(), stride=stride, groups=groups,
                        dilation=dilation).to(x.dtype)


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense 3x3/s1 SAME conv oracle (the reference's back-compat
    alias)."""
    return conv_ref(x, w, stride=1)


def vsconv_ref(
    x: torch.Tensor,
    w_vs: VectorSparse,
    *,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    groups: int = 1,
    dilation: int = 1,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """kh x kw / stride / dilation / SAME (grouped) conv against the
    densified (kh*kw*Cin/groups, Cout) weight, NHWC in and out."""
    c = x.shape[-1]
    k, cout = w_vs.shape
    if k != kh * kw * (c // groups):
        raise ValueError(f"weight {w_vs.shape} does not match a {kh}x{kw} "
                         f"conv over {c} channels in {groups} groups")
    w = decode(w_vs).reshape(kh, kw, c // groups, cout)
    y = dense_conv2d(x.float(), w.float(), stride=stride, groups=groups,
                     dilation=dilation)
    return _epilogue(y, bias, residual, fuse_relu).to(x.dtype)
