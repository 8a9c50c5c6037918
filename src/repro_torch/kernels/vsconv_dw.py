"""vsconv_dw — the depthwise vector-sparse convolution, over both layouts.

A depthwise conv (groups == C, multiplier 1) has one kh x kw filter per
channel.  Its weight is the (kh*kw, C) tap matrix encoded with vk = 1 over
vc-channel strips: strip j is channel tile j, each stored vector is one
tap's weights across the tile, and ``idx[j, s]`` is the BARE tap id
``ky*kw + kx`` (not ``tap*CB + tile`` as in the full conv).  The MAC is
elementwise per channel.

The kernels (``csrc/vsconv_dw.cu``) replace the JAX package's Pallas
kernels

* `repro/kernels/vsconv.py::vsconv_dw_halo_pallas` by
  ``vsconv_dw_halo_kernel``, over `build_halo_input(x, vk=vc)`;
* `repro/kernels/vsconv.py::vsconv_dw_stack_pallas` by
  ``vsconv_dw_stack_kernel``, over `build_row_tap_stack`.

`vsconv_dw_halo_kernel` and `vsconv_dw_stack_kernel` are the wrappers:
each launches its kernel for CUDA tensors and runs its plain version
(`vsconv_dw_plain`, `vsconv_dw_stack_plain`) for CPU tensors; a CUDA
tensor the kernel does not take raises.  Their ``launches`` attributes
count launches.  `dw_halo_kernel_cost` and `dw_stack_kernel_cost` are the
reference TPU kernels' cost model, copied for cost tooling; they do not
describe the CUDA kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_ops import (patch_conv, tap_matrix_width,
                                         tap_patches)
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels._build import launch
from repro_torch.kernels.vsconv import halo_h_out, stack_h_out, stack_patches
from repro_torch.kernels.vsmm import MAX_VN, check_epilogue, check_operands

__all__ = [
    "vsconv_dw_halo_kernel", "vsconv_dw_plain", "vsconv_dw_stack_kernel",
    "vsconv_dw_stack_plain", "dw_halo_kernel_cost", "dw_stack_kernel_cost",
]


def dw_halo_kernel_cost(
    *, n: int, hop: int, w_out: int, kh: int, stride: int, bwp: int, bh: int,
    nb: int, s_steps: int, vc: int, dilation: int = 1, in_itemsize: int = 4,
    w_itemsize: int = 4, out_itemsize: int = 4, residual_bytes: int = 0,
) -> dict[str, int]:
    """TPU cost model of the reference's depthwise halo kernel (not the
    CUDA kernel's cost): one halo block of ``stride*(bh-1) +
    (kh-1)*dilation + 1`` rows per (strip, row-block), whatever the tap
    order; one MAC per (pixel, channel, stored tap)."""
    hb = hop // bh
    hh = stride * (bh - 1) + (kh - 1) * dilation + 1
    return {
        "flops": 2 * n * hop * w_out * nb * s_steps * vc,
        "bytes_accessed": (
            n * hb * nb * hh * bwp * vc * in_itemsize
            + nb * s_steps * vc * w_itemsize
            + n * hop * w_out * nb * vc * out_itemsize
            + residual_bytes
        ),
    }


def dw_stack_kernel_cost(
    *, n: int, hop: int, w_out: int, bw: int, bh: int, nb: int, s_steps: int,
    vc: int, in_itemsize: int = 4, w_itemsize: int = 4, out_itemsize: int = 4,
    residual_bytes: int = 0,
) -> dict[str, int]:
    """TPU cost model of the reference's depthwise stack kernel (not the
    CUDA kernel's cost): a (bh, bw, vc) input block per sparse step."""
    hb = hop // bh
    return {
        "flops": 2 * n * hop * w_out * nb * s_steps * vc,
        "bytes_accessed": (
            n * hb * nb * s_steps * bh * bw * vc * in_itemsize
            + nb * s_steps * vc * w_itemsize
            + n * hop * w_out * nb * vc * out_itemsize
            + residual_bytes
        ),
    }


def vsconv_dw_plain(
    xh: torch.Tensor,
    vs: VectorSparse,
    *,
    w_out: int,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    dilation: int = 1,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the depthwise halo kernel on the same
    halo buffer (`build_halo_input(x, vk=vc)`): the taps are cut out of the
    buffer and, step by step, each channel tile's stored tap vector scales
    its input at that tap.  Runs on any device."""
    h_out = halo_h_out(xh.shape, w_out=w_out, kh=kh, kw=kw, stride=stride,
                       dilation=dilation)
    n, rows, bw, cb, vc = xh.shape
    if tap_matrix_width(vs, kh * kw, cb * vc) != vc:
        raise ValueError(f"halo channel tile {vc} is not the strip width "
                         f"{vs.vn}")
    patches = tap_patches(xh.reshape(n, rows, bw, cb * vc), kh=kh, kw=kw,
                          stride=stride, dilation=dilation, h_out=h_out,
                          w_out=w_out)
    return patch_conv(patches, vs, taps=kh * kw, groups=cb * vc,
                      depthwise=True, bias=bias, residual=residual,
                      scale=scale, fuse_relu=fuse_relu)


def vsconv_dw_stack_plain(
    xt: torch.Tensor,
    vs: VectorSparse,
    *,
    w_out: int,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    dilation: int = 1,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the depthwise stack kernel on the same
    stack (N, kh*stride, H, bW, C).  Runs on any device."""
    stack_h_out(xt.shape, w_out=w_out, kh=kh, kw=kw, stride=stride,
                dilation=dilation)
    patches = stack_patches(xt, kh=kh, kw=kw, stride=stride,
                            dilation=dilation, w_out=w_out)
    return patch_conv(patches, vs, taps=kh * kw, groups=xt.shape[-1],
                      depthwise=True, bias=bias, residual=residual,
                      scale=scale, fuse_relu=fuse_relu)


def _dw_kernel(fn: str, x: torch.Tensor, vs: VectorSparse, *, h_out: int,
               w_out: int, d0: int, bw: int, c: int, kh: int, kw: int,
               stride: int, dilation: int, bias: torch.Tensor | None,
               residual: torch.Tensor | None, scale: torch.Tensor | None,
               fuse_relu: bool) -> torch.Tensor:
    """Checks and launch shared by the two depthwise kernels; ``d0`` is
    the buffer's second dimension (halo rows or stack planes)."""
    vc = tap_matrix_width(vs, kh * kw, c)
    if vc > MAX_VN:
        raise ValueError(f"{fn} takes vc <= {MAX_VN}, got {vc}")
    n = x.shape[0]
    out_shape = (n, h_out, w_out, c)
    check_epilogue(bias=bias, scale=scale, residual=residual, cout=c,
                   out_shape=out_shape)
    check_operands({"x": x, "vals": vs.vals, "idx": vs.idx, "bias": bias,
                    "scale": scale, "residual": residual}, x.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    if out.numel():
        launch("vsconv_dw", fn,
               (x, vs.vals, vs.idx, scale, bias, residual, out),
               (n, d0, bw, c // vc, h_out, w_out, kw, stride, dilation,
                vs.nnz_per_strip, vc, int(fuse_relu)), x.device)
    return out


def vsconv_dw_halo_kernel(
    xh: torch.Tensor,
    vs: VectorSparse,
    *,
    w_out: int,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    dilation: int = 1,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """Depthwise over the halo buffer xh (N, rows, bW, CB, vc) with the
    (kh*kw, C) tap matrix -> (N, Hout, w_out, C) f32.

    CUDA tensors launch ``vsconv_dw_halo_kernel`` of ``csrc/vsconv_dw.cu``
    on the current stream (built at first use); CPU tensors run
    `vsconv_dw_plain`.  ``bias``/``scale`` are (C,), ``residual`` output
    shaped.
    """
    kw_ = dict(w_out=w_out, kh=kh, kw=kw, stride=stride, dilation=dilation,
               bias=bias, residual=residual, scale=scale, fuse_relu=fuse_relu)
    if xh.device.type == "cpu":
        return vsconv_dw_plain(xh, vs, **kw_)
    if xh.device.type != "cuda":
        raise ValueError(f"vsconv_dw_halo_kernel runs on cuda or cpu, "
                         f"not {xh.device}")
    h_out = halo_h_out(xh.shape, w_out=w_out, kh=kh, kw=kw, stride=stride,
                       dilation=dilation)
    _, rows, bw, cb, vc = xh.shape
    if vc != vs.vn:
        raise ValueError(f"halo channel tile {vc} is not the strip width "
                         f"{vs.vn}")
    out = _dw_kernel("vsconv_dw_halo_launch", xh, vs, h_out=h_out, d0=rows,
                     bw=bw, c=cb * vc, **kw_)
    vsconv_dw_halo_kernel.launches += 1
    return out


vsconv_dw_halo_kernel.launches = 0  # type: ignore[attr-defined]


def vsconv_dw_stack_kernel(
    xt: torch.Tensor,
    vs: VectorSparse,
    *,
    w_out: int,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    dilation: int = 1,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
) -> torch.Tensor:
    """Depthwise over the row-tap stack xt (N, kh*stride, Hout, bW, C) with
    the (kh*kw, C) tap matrix -> (N, Hout, w_out, C) f32.

    CUDA tensors launch ``vsconv_dw_stack_kernel`` of
    ``csrc/vsconv_dw.cu`` on the current stream (built at first use); CPU
    tensors run `vsconv_dw_stack_plain`.
    """
    kw_ = dict(w_out=w_out, kh=kh, kw=kw, stride=stride, dilation=dilation,
               bias=bias, residual=residual, scale=scale, fuse_relu=fuse_relu)
    if xt.device.type == "cpu":
        return vsconv_dw_stack_plain(xt, vs, **kw_)
    if xt.device.type != "cuda":
        raise ValueError(f"vsconv_dw_stack_kernel runs on cuda or cpu, "
                         f"not {xt.device}")
    h_out = stack_h_out(xt.shape, w_out=w_out, kh=kh, kw=kw, stride=stride,
                        dilation=dilation)
    _, planes, _, bw, c = xt.shape
    out = _dw_kernel("vsconv_dw_stack_launch", xt, vs, h_out=h_out,
                     d0=planes, bw=bw, c=c, **kw_)
    vsconv_dw_stack_kernel.launches += 1
    return out


vsconv_dw_stack_kernel.launches = 0  # type: ignore[attr-defined]
