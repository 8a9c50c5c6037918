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
count launches.  Both kernels have an int8 branch (int8 window and taps,
converted to f32 for the MAC: every product and sum is an exact integer,
bit-equal to the reference's f32 MAC on int8 values), counted on
``int8_launches`` too.  ``skip_zero_inputs=False`` (the reference's flag,
the paper's dense-input mode) turns the kernels' input-side skip off: the
same bits, since a skipped window adds exact zeros; the plain versions
never skip.  `dw_tile` picks the 2-D output tile a block of either kernel
takes.
`dw_halo_kernel_cost` and `dw_stack_kernel_cost` are the reference TPU
kernels' cost model, copied for cost tooling; they do not describe the
CUDA kernels.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.sparse_ops import (patch_conv, tap_matrix_width,
                                         tap_patches)
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels._build import launch
from repro_torch.kernels.vsconv import halo_h_out, stack_h_out, stack_patches
from repro_torch.kernels.vsmm import (MAX_VN, check_epilogue, check_operands,
                                      entry_name)

__all__ = [
    "vsconv_dw_halo_kernel", "vsconv_dw_plain", "vsconv_dw_stack_kernel",
    "vsconv_dw_stack_plain", "dw_halo_kernel_cost", "dw_stack_kernel_cost",
    "dw_tile", "dw_window_bytes", "dw_halo_in_index_map",
    "dw_stack_in_index_map",
]

# The kernels' tile rule, per layout: (output elements a block aims at,
# tile shape, threads a block).  The halo takes square-ish tiles; the
# stack stages kh*stride planes per output row, so its blocks take one
# output row each, more and smaller blocks (the faster shapes in a sweep
# of tiles and thread counts on an H100).  Then a staged window of at most
# DW_WINDOW_BYTES, and at least DW_MIN_BLOCKS blocks (two per SM of an
# H100) where the layer has them.
DW_TILE = {"halo": (4096, "square", 256), "stack": (1024, "row", 128)}
DW_WINDOW_BYTES = 64 * 1024
DW_MIN_BLOCKS = 2 * 132


def dw_window_bytes(th: int, tw: int, vc: int, *, kh: int, kw: int,
                    stride: int, dilation: int, layout: str) -> int:
    """Bytes of the input window a block of a th x tw output tile stages
    (``csrc/vsconv_dw.cu``'s `window_dims`)."""
    if layout == "stack":
        pixels = kh * stride * th * (tw + ((kw - 1) * dilation) // stride)
    else:
        pixels = (((th - 1) * stride + (kh - 1) * dilation + 1)
                  * ((tw - 1) * stride + (kw - 1) * dilation + 1))
    return 4 * pixels * vc


@functools.lru_cache(maxsize=None)
def dw_tile(n: int, h_out: int, w_out: int, c: int, vc: int, *, kh: int,
            kw: int, stride: int, dilation: int, layout: str
            ) -> tuple[int, int, int]:
    """(th, tw, threads): the output tile and threads of one block of the
    depthwise kernels.

    Start from ``elems / vc`` pixels (`DW_TILE`): halo, th a power of two
    and tw = pixels / th (vc 32: 8 x 16, vc 64: 8 x 8, vc 128: 4 x 8);
    stack, one row of them (vc 32: 1 x 32, vc 128: 1 x 8).  Take a whole
    image dimension where it is less than two tiles; then halve the
    larger side (th on a tie) while the window exceeds DW_WINDOW_BYTES,
    and while the grid has fewer than DW_MIN_BLOCKS blocks."""
    elems, shape, threads = DW_TILE[layout]
    px = max(1, elems // vc)
    th = 1 << ((px.bit_length() - 1) // 2) if shape == "square" else 1
    tw = max(1, px // th)
    th, tw = min(th, h_out), min(tw, w_out)
    if h_out < 2 * th:
        th = h_out
    if w_out < 2 * tw:
        tw = w_out

    def halve(th: int, tw: int) -> tuple[int, int]:
        return ((th + 1) // 2, tw) if th >= tw else (th, (tw + 1) // 2)

    geo = dict(kh=kh, kw=kw, stride=stride, dilation=dilation, layout=layout)
    while th * tw > 1 and dw_window_bytes(th, tw, vc, **geo) > \
            DW_WINDOW_BYTES:
        th, tw = halve(th, tw)
    while th * tw > 1 and (n * -(-h_out // th) * -(-w_out // tw) * (c // vc)
                           < DW_MIN_BLOCKS):
        th, tw = halve(th, tw)
    return th, tw, threads


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


def dw_halo_in_index_map(hb: int, stride: int, bh: int):
    """The reference's depthwise halo input map (element offsets; grid
    (j, m, s)): strip j is the channel tile and the offset does not depend
    on the tap, so the halo is fetched once per (strip, row-block).  A
    plain integer function of the layout contract (see the index maps in
    `kernels.vsconv`)."""
    def index_map(j, m, s, idx):
        return (m // hb, (m % hb) * stride * bh, 0, j, 0)
    return index_map


def dw_stack_in_index_map(hb: int, kw: int, stride: int, dilation: int):
    """The reference's depthwise row-tap stack input map (block indices):
    ``idx[j, s]`` is the bare tap id and the strip is the channel tile."""
    def index_map(j, m, s, idx):
        t = idx[j, s]
        return (
            m // hb,
            (t // kw) * stride + ((t % kw) * dilation) % stride,  # (ky, ph)
            m % hb,
            0,
            j,
        )
    return index_map


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
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version of the depthwise halo kernel on the same
    halo buffer (`build_halo_input(x, vk=vc)`): the taps are cut out of the
    buffer and, step by step, each channel tile's stored tap vector scales
    its input at that tap.  Runs on any device and never skips."""
    del skip_zero_inputs
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
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version of the depthwise stack kernel on the same
    stack (N, kh*stride, H, bW, C).  Runs on any device and never
    skips."""
    del skip_zero_inputs
    stack_h_out(xt.shape, w_out=w_out, kh=kh, kw=kw, stride=stride,
                dilation=dilation)
    patches = stack_patches(xt, kh=kh, kw=kw, stride=stride,
                            dilation=dilation, w_out=w_out)
    return patch_conv(patches, vs, taps=kh * kw, groups=xt.shape[-1],
                      depthwise=True, bias=bias, residual=residual,
                      scale=scale, fuse_relu=fuse_relu)


def _dw_kernel(layout: str, x: torch.Tensor, vs: VectorSparse, *, h_out: int,
               w_out: int, d0: int, bw: int, c: int, kh: int, kw: int,
               stride: int, dilation: int, bias: torch.Tensor | None,
               residual: torch.Tensor | None, scale: torch.Tensor | None,
               fuse_relu: bool, skip_zero_inputs: bool
               ) -> tuple[torch.Tensor, bool]:
    """Checks and launch shared by the two depthwise kernels (``layout``
    "halo" or "stack"); ``d0`` is the buffer's second dimension (halo rows
    or stack planes).  Returns the output and whether the int8 branch
    ran."""
    fn = f"vsconv_dw_{layout}_launch"
    vc = tap_matrix_width(vs, kh * kw, c)
    if vc > MAX_VN:
        raise ValueError(f"{fn} takes vc <= {MAX_VN}, got {vc}")
    if kh * stride > 32:
        raise ValueError(f"{fn} takes kh*stride <= 32, got {kh * stride}")
    n = x.shape[0]
    out_shape = (n, h_out, w_out, c)
    check_epilogue(bias=bias, scale=scale, residual=residual, cout=c,
                   out_shape=out_shape)
    int8 = check_operands({"x": x, "vals": vs.vals, "idx": vs.idx,
                           "bias": bias, "scale": scale,
                           "residual": residual}, x.device)
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    if out.numel():
        th, tw, threads = dw_tile(n, h_out, w_out, c, vc, kh=kh, kw=kw,
                                  stride=stride, dilation=dilation,
                                  layout=layout)
        # 4 channels a copy: 16 bytes in f32, 4 in int8
        align = 4 if int8 else 16
        vec = 4 if (vc % 4 == 0 and x.data_ptr() % align == 0
                    and vs.vals.data_ptr() % align == 0) else 1
        launch("vsconv_dw", entry_name(fn, int8),
               (x, vs.vals, vs.idx, scale, bias, residual, out),
               (n, d0, bw, c // vc, h_out, w_out, kw, stride, dilation,
                vs.nnz_per_strip, vc, int(fuse_relu), kh, th, tw, vec,
                threads, int(skip_zero_inputs)),
               x.device)
    return out, int8


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
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """Depthwise over the halo buffer xh (N, rows, bW, CB, vc) with the
    (kh*kw, C) tap matrix -> (N, Hout, w_out, C) f32.

    CUDA tensors launch ``vsconv_dw_halo_kernel`` of ``csrc/vsconv_dw.cu``
    on the current stream (built at first use); CPU tensors run
    `vsconv_dw_plain`.  ``bias``/``scale`` are (C,), ``residual`` output
    shaped.  int8 ``xh`` and ``vs.vals`` with a ``scale`` launch the int8
    branch (counted on ``int8_launches`` too).
    """
    kw_ = dict(w_out=w_out, kh=kh, kw=kw, stride=stride, dilation=dilation,
               bias=bias, residual=residual, scale=scale, fuse_relu=fuse_relu,
               skip_zero_inputs=skip_zero_inputs)
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
    out, int8 = _dw_kernel("halo", xh, vs, h_out=h_out, d0=rows,
                           bw=bw, c=cb * vc, **kw_)
    vsconv_dw_halo_kernel.launches += 1
    vsconv_dw_halo_kernel.int8_launches += int(int8)
    return out


vsconv_dw_halo_kernel.launches = 0  # type: ignore[attr-defined]
vsconv_dw_halo_kernel.int8_launches = 0  # type: ignore[attr-defined]


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
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """Depthwise over the row-tap stack xt (N, kh*stride, Hout, bW, C) with
    the (kh*kw, C) tap matrix -> (N, Hout, w_out, C) f32.

    CUDA tensors launch ``vsconv_dw_stack_kernel`` of
    ``csrc/vsconv_dw.cu`` on the current stream (built at first use); CPU
    tensors run `vsconv_dw_stack_plain`.  int8 ``xt`` and ``vs.vals``
    with a ``scale`` launch the int8 branch (counted on ``int8_launches``
    too).
    """
    kw_ = dict(w_out=w_out, kh=kh, kw=kw, stride=stride, dilation=dilation,
               bias=bias, residual=residual, scale=scale, fuse_relu=fuse_relu,
               skip_zero_inputs=skip_zero_inputs)
    if xt.device.type == "cpu":
        return vsconv_dw_stack_plain(xt, vs, **kw_)
    if xt.device.type != "cuda":
        raise ValueError(f"vsconv_dw_stack_kernel runs on cuda or cpu, "
                         f"not {xt.device}")
    h_out = stack_h_out(xt.shape, w_out=w_out, kh=kh, kw=kw, stride=stride,
                        dilation=dilation)
    _, planes, _, bw, c = xt.shape
    out, int8 = _dw_kernel("stack", xt, vs, h_out=h_out,
                           d0=planes, bw=bw, c=c, **kw_)
    vsconv_dw_stack_kernel.launches += 1
    vsconv_dw_stack_kernel.int8_launches += int(int8)
    return out


vsconv_dw_stack_kernel.launches = 0  # type: ignore[attr-defined]
vsconv_dw_stack_kernel.int8_launches = 0  # type: ignore[attr-defined]
