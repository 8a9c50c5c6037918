"""vsconv — the direct vector-sparse convolution over the halo layout.

The kernel (``csrc/vsconv.cu``) replaces the JAX package's Pallas kernel
`repro/kernels/vsconv.py::vsconv_halo_pallas`, both of its bodies (streaming
and resident).  It reads `build_halo_input`'s SAME-padded NHWC buffer
directly and resolves each stored tile's tap (ky, kx) and cin tile from
its id inside the kernel, so no tap-shifted copy of the input is ever
made.  A conv weight (kh*kw*Cin, Cout) has K-tile ids
``t = (ky*kw + kx) * cb + cin_tile`` with ``cb = Cin // vk``.

`vsconv_halo_kernel` is the wrapper: it launches the kernel for CUDA
tensors and runs `vsconv_plain` for CPU tensors; a CUDA tensor the kernel
does not take raises.  ``vsconv_halo_kernel.launches`` counts launches.

The layout helpers (`halo_layout_dims`, `build_halo_input`) are kept
byte-for-byte with the reference.  `halo_kernel_cost`, `use_resident_halo`
and `RESIDENT_MAX_H` are the reference TPU kernel's cost model (its
per-row-block halo DMAs and its resident layout), copied so that cost
tooling can compare against it; they do not describe the CUDA kernel,
which needs no row-block padding of Hout (a TPU block constraint) and no
second body for tiny feature maps (a TPU DMA choice).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_ops import same_pads, tap_patches
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels import _build
from repro_torch.kernels.vsmm import MAX_VN, _ptr, check_operands, vsmm_plain

__all__ = [
    "vsconv_halo_kernel", "vsconv_plain", "build_halo_input",
    "halo_layout_dims", "halo_kernel_cost", "use_resident_halo",
    "RESIDENT_MAX_H",
]

# Below this output height the reference's halo kernel switches to its
# resident whole-input layout (a TPU DMA choice, kept for its cost model).
RESIDENT_MAX_H = 4


def use_resident_halo(h_out: int, groups: int) -> bool:
    """True when the reference TPU kernel runs its tiny-feature-map
    resident layout (the CUDA kernel has one body for every Hout)."""
    return h_out < RESIDENT_MAX_H and groups == 1


def halo_kernel_cost(
    *, n: int, hop: int, w_out: int, kh: int, stride: int, bwp: int, bh: int,
    nb: int, s_steps: int, cb: int, vk: int, vn: int, dilation: int = 1,
    resident: bool = False, in_itemsize: int = 4, w_itemsize: int = 4,
    out_itemsize: int = 4, residual_bytes: int = 0,
) -> dict[str, int]:
    """TPU cost model of the reference's halo kernel (not the CUDA
    kernel's cost): each of the min(S, cb) distinct cin tiles of a strip
    fetches one halo block of ``stride*(bh-1) + (kh-1)*dilation + 1`` rows
    per (strip, row-block); the resident layout fetches all ``cb`` tiles
    once per row-block."""
    hb = hop // bh
    hh = stride * (bh - 1) + (kh - 1) * dilation + 1
    if resident:
        input_bytes = n * hb * hh * bwp * cb * vk * in_itemsize
    else:
        input_bytes = (n * hb * nb * min(s_steps, cb) * hh * bwp * vk
                       * in_itemsize)
    return {
        "flops": 2 * n * hop * w_out * nb * s_steps * vk * vn,
        "bytes_accessed": (
            input_bytes
            + nb * s_steps * vk * vn * w_itemsize
            + n * hop * w_out * nb * vn * out_itemsize
            + residual_bytes
        ),
    }


def halo_layout_dims(h: int, w: int, *, kh: int, kw: int, stride: int,
                     dilation: int, h_out: int, sublane: int = 8
                     ) -> tuple[int, int]:
    """(rows, bW) of `build_halo_input`'s padded buffer."""
    wo, _, _ = same_pads(w, kw, stride, dilation)
    rows = stride * (h_out - 1) + (kh - 1) * dilation + 1
    bw = -(-(stride * (wo - 1) + (kw - 1) * dilation + 1) // sublane) * sublane
    return rows, bw


def build_halo_input(
    x: torch.Tensor,
    *,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    dilation: int = 1,
    vk: int,
    h_out: int | None = None,
    sublane: int = 8,
) -> torch.Tensor:
    """NHWC -> (N, rows, bW, CB, vk) SAME-padded direct input.

    One `F.pad` (asymmetric where SAME is) plus a free channel-split view:
    rows = stride*(Hout-1) + ke_h so every tap stays in bounds, bW =
    stride*(Wout-1) + ke_w rounded up to ``sublane`` (the reference's
    layout, kept byte-for-byte).  ``h_out`` rounds Hout up (extra rows read
    zero padding).
    """
    n, h, w, c = x.shape
    if c % vk:
        raise ValueError(f"{c} channels do not tile by vk={vk}")
    ho, pt, _ = same_pads(h, kh, stride, dilation)
    _, pl, _ = same_pads(w, kw, stride, dilation)
    ho = h_out or ho
    rows, bw = halo_layout_dims(h, w, kh=kh, kw=kw, stride=stride,
                                dilation=dilation, h_out=ho, sublane=sublane)
    xp = F.pad(x, (0, 0, pl, bw - w - pl, pt, rows - h - pt))
    return xp.contiguous().reshape(n, rows, bw, c // vk, vk)


def _halo_geometry(xh: torch.Tensor, vs: VectorSparse, *, w_out: int,
                   kh: int, kw: int, stride: int, dilation: int
                   ) -> tuple[int, int]:
    """(h_out, cb) of a halo conv; raises where the shapes disagree or a
    tap would read outside xh."""
    n, rows, bw, cb, vk = xh.shape
    ke_h = (kh - 1) * dilation + 1
    ke_w = (kw - 1) * dilation + 1
    if rows < ke_h or (rows - ke_h) % stride:
        raise ValueError(f"halo rows {rows} do not fit kh={kh} "
                         f"dilation={dilation} stride={stride}")
    h_out = (rows - ke_h) // stride + 1
    if stride * (w_out - 1) + ke_w > bw:
        raise ValueError(f"w_out={w_out} reads past the halo width {bw}")
    if vs.vk != vk or vs.shape[0] != kh * kw * cb * vk:
        raise ValueError(f"weight {vs.shape} (vk={vs.vk}) does not match "
                         f"xh {tuple(xh.shape)} with a {kh}x{kw} kernel")
    return h_out, cb


def vsconv_plain(
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
    """The plain PyTorch version of the kernel on the same halo input:
    the taps are cut out of the padded buffer (im2col) and the structural
    `vsmm_plain` multiplies the stored tiles.  Runs on any device."""
    h_out, _ = _halo_geometry(xh, vs, w_out=w_out, kh=kh, kw=kw,
                              stride=stride, dilation=dilation)
    n, rows, bw, cb, vk = xh.shape
    patches = tap_patches(xh.reshape(n, rows, bw, cb * vk), kh=kh, kw=kw,
                          stride=stride, dilation=dilation, h_out=h_out,
                          w_out=w_out)
    cout = vs.shape[1]
    res2 = None if residual is None else residual.reshape(-1, cout)
    y = vsmm_plain(patches.reshape(-1, patches.shape[-1]), vs, bias=bias,
                   residual=res2, scale=scale, fuse_relu=fuse_relu)
    return y.reshape(n, h_out, w_out, cout)


def _lib() -> ctypes.CDLL:
    lib = _build.load("vsconv")
    fn = lib.vsconv_halo_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def vsconv_halo_kernel(
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
    """Direct input xh (N, rows, bW, CB, vk) * sparse (kh*kw*CB*vk, Cout)
    -> (N, Hout, w_out, Cout) f32 with Hout = (rows - ke_h) // stride + 1.

    CUDA tensors launch ``csrc/vsconv.cu`` on the current stream (built at
    first use); CPU tensors run `vsconv_plain`.  ``bias``/``scale`` are
    (Cout,), ``residual`` (N, Hout, w_out, Cout).
    """
    if xh.device.type == "cpu":
        return vsconv_plain(xh, vs, w_out=w_out, kh=kh, kw=kw, stride=stride,
                            dilation=dilation, bias=bias, residual=residual,
                            scale=scale, fuse_relu=fuse_relu)
    if xh.device.type != "cuda":
        raise ValueError(f"vsconv_halo_kernel runs on cuda or cpu, "
                         f"not {xh.device}")
    h_out, cb = _halo_geometry(xh, vs, w_out=w_out, kh=kh, kw=kw,
                               stride=stride, dilation=dilation)
    n, rows, bw, _, vk = xh.shape
    nb, s_steps, _, vn = vs.vals.shape
    cout = nb * vn
    if vn > MAX_VN:
        raise ValueError(f"vsconv_halo_kernel takes vn <= {MAX_VN}, got {vn}")
    for name, t, shape in (("bias", bias, (cout,)), ("scale", scale, (cout,)),
                           ("residual", residual, (n, h_out, w_out, cout))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, expected {shape}")
    check_operands({"xh": xh, "vals": vs.vals, "idx": vs.idx, "bias": bias,
                    "scale": scale, "residual": residual}, xh.device)
    out = torch.empty((n, h_out, w_out, cout), dtype=torch.float32,
                      device=xh.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vsconv_halo_launch(
            _ptr(xh), _ptr(vs.vals), _ptr(vs.idx), _ptr(scale), _ptr(bias),
            _ptr(residual), _ptr(out), n, rows, bw, cb, h_out, w_out, kw,
            stride, dilation, nb, s_steps, vk, vn, int(fuse_relu),
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"vsconv kernel launch failed: CUDA error {err}")
    vsconv_halo_kernel.launches += 1
    return out


vsconv_halo_kernel.launches = 0  # type: ignore[attr-defined]
