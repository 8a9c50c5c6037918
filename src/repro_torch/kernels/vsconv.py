"""vsconv — the direct vector-sparse convolution over two input layouts.

The kernels (``csrc/vsconv.cu``) replace the JAX package's Pallas kernels

* `repro/kernels/vsconv.py::vsconv_halo_pallas`, both of its bodies
  (streaming and resident), by ``vsconv_halo_kernel``: it reads
  `build_halo_input`'s SAME-padded NHWC buffer directly and resolves each
  stored tile's tap (ky, kx) and cin tile from its id inside the kernel,
  so no tap-shifted copy of the input is ever made;
* `repro/kernels/vsconv.py::vsconv_pallas` by ``vsconv_stack_kernel``: the
  same conv over `build_row_tap_stack`'s materialized kh*stride planes
  (the reference's oracle and fallback layout), where tap (ky, kx) reads
  plane ``ky*stride + (kx*d) % stride`` at column offset
  ``(kx*d) // stride``.

A conv weight (kh*kw*Cin/groups, Cout) has K-tile ids
``t = (ky*kw + kx) * cbg + cin_tile`` with ``cbg = Cin // (groups*vk)``
cin tiles per group; strips are group-major, so strip j reads the cin
tiles of group ``j // (NB/groups)`` (the group base ``(j // spg) * cbg``
is added in the kernel).

`vsconv_halo_kernel` and `vsconv_stack_kernel` are the wrappers: each
launches its kernel for CUDA tensors and runs its plain version
(`vsconv_plain`, `vsconv_stack_plain`) for CPU tensors; a CUDA tensor the
kernel does not take raises.  Their ``launches`` attributes count
launches.

Every conv but the stems runs the generic body: `conv_plan` cuts the work
from the shapes alone into tiles of 64 or 128 output pixels, the output
strips and, where those do not fill the card's SMs, ``splits`` chunks of
each strip's stored steps.  A block streams its steps through a 3-stage
``cp.async`` ring (one stored tile and its gathered activations a stage,
one barrier a stage, which carries the zero-skip vote).  f32 runs
register-tiled FMAs on the CUDA cores (8 x 8 or 8 x 4 outputs a thread);
int8 runs one exact ``mma.sync.m16n8k32.s8`` a stored tile of vk 32.
With ``splits > 1`` the kernel runs in two phases on the current stream:
each chunk's partial goes to a workspace (allocated here, no host sync),
and a second launch sums the chunks in chunk order and applies the
epilogue, so the output has the same bits from run to run.

Both kernels have a second body for the CNN stems (narrow inputs, vk 8: a
2-D output tile over a shared-memory window, see ``csrc/vsconv.cu``),
picked by `use_stem_body`; its launches count on ``launches`` too and,
besides, on ``stem_launches``.  If a body fails to build or launch, the
wrapper raises: it never carries on in another body or on the CPU.

Both bodies have an int8 branch (int8 buffer and tiles, a per-column
dequant scale): each stored step's partial is an exact integer, added
into the f32 accumulator in stored order, bit-equal to the plain versions
and the reference (a split keeps each chunk's exact integer sum and
recomputes in stored order any element whose sums might pass 2^24).  Its
launches count on ``int8_launches`` too; int8 stems take the int8 stem
body (an int8 window, ``dp4a`` partials) under the same rule as f32
stems.

``skip_zero_inputs`` (default True) is the reference's flag: False turns
the kernels' input-side skip off (the paper's dense-input mode), so every
stored tile's MAC runs.  A skipped tile adds exact zeros, so the output
has the same bits either way; the plain versions never skip.

The layout helpers (`halo_layout_dims`, `build_halo_input`,
`stack_layout_dims`, `build_row_tap_stack`) are kept byte-for-byte with
the reference.  `halo_kernel_cost`, `stack_kernel_cost`,
`use_resident_halo` and `RESIDENT_MAX_H` are the reference TPU kernels'
cost model (per-row-block DMAs, the resident layout), copied so that cost
tooling can compare against it; they do not describe the CUDA kernels,
which need no row-block padding of Hout (a TPU block constraint) and no
second body for tiny feature maps (a TPU DMA choice).
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.sparse_ops import patch_conv, same_pads, tap_patches
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels._build import launch
from repro_torch.kernels.vsmm import (MAX_VN, SMS, TARGET_BLOCKS,
                                      check_epilogue, check_operands,
                                      entry_name)

__all__ = [
    "vsconv_halo_kernel", "vsconv_plain", "vsconv_stack_kernel",
    "vsconv_stack_plain", "build_halo_input", "halo_layout_dims",
    "build_row_tap_stack", "stack_layout_dims", "stack_patches",
    "halo_kernel_cost", "stack_kernel_cost", "use_resident_halo",
    "RESIDENT_MAX_H", "halo_h_out", "stack_h_out", "use_stem_body",
    "stem_smem_bytes", "conv_plan", "conv_smem_bytes", "conv_fast",
    "CONV_ROWS", "CONV_MIN_CHUNK", "MAX_VK",
]

# Below this output height the reference's halo kernel switches to its
# resident whole-input layout (a TPU DMA choice, kept for its cost model).
RESIDENT_MAX_H = 4


def use_resident_halo(h_out: int, groups: int) -> bool:
    """True when the reference TPU kernel runs its tiny-feature-map
    resident layout (the CUDA kernel has one body for every Hout)."""
    return h_out < RESIDENT_MAX_H and groups == 1


# The stem body's tile (csrc/vsconv.cu, namespace stem): 8 x 16 output
# pixels a block, window rows padded by 4 floats, stored tiles staged 4 at
# a time, double-buffered.
STEM_TH, STEM_TW, STEM_CHUNK, STEM_VK, STEM_ROW_PAD = 8, 16, 4, 8, 4
STEM_CHANNELS = (8, 16)   # input channels C = CB*vk the body takes
STEM_VN = (32, 64)        # strip widths it takes (one or two columns a lane)
STEM_MAX_SMEM = 227 * 1024  # an H100 block's shared memory


def stem_smem_bytes(c: int, vn: int, *, kh: int, kw: int, stride: int,
                    dilation: int, layout: str, itemsize: int = 4) -> int:
    """Shared memory of one stem-body block at the most stored tiles a
    strip can hold (S = kh*kw*CB): the input window (C elements a pixel,
    columns split by phase; f32 rows padded by 4 floats, int8 rows
    rounded up to 16 bytes), two weight chunks (C elements a tile row) and
    two ints per stored tile.  ``itemsize`` 4 is the f32 body, 1 the
    int8 one."""
    pw = STEM_TW + ((kw - 1) * dilation) // stride
    if layout == "stack":
        rows = kh * stride * STEM_TH
    else:
        rows = ((STEM_TH - 1) * stride + (kh - 1) * dilation + 1) * stride
    s_max = kh * kw * (c // STEM_VK)
    if itemsize == 1:
        row_bytes = -(-pw * c // 16) * 16
    else:
        row_bytes = 4 * (pw * c + STEM_ROW_PAD)
    return (rows * row_bytes + itemsize * 2 * STEM_CHUNK * STEM_VK * vn
            + 8 * s_max)


@functools.lru_cache(maxsize=None)
def use_stem_body(c: int, vk: int, groups: int, kh: int, kw: int, vn: int,
                  *, stride: int = 1, dilation: int = 1,
                  int8: bool = False) -> bool:
    """True when the conv kernels run their stem body: an ungrouped conv
    with kh*kw > 1 over a narrow input, C = CB*vk of 8 or 16 channels in
    K-tiles of vk 8 (what `models/graph.py::conv_tile_geometry` gives any
    cin that does not tile by 32), vn 32 or 64, and an f32 window that
    fits an H100 block's shared memory in both layouts.  The rule is the
    same for f32 and int8 (``int8`` picks the int8 twin of the body, whose
    window is smaller); every other conv runs the generic body."""
    del int8  # the same shape rule for both bodies
    return (groups == 1 and kh * kw > 1 and vk == STEM_VK
            and c in STEM_CHANNELS and vn in STEM_VN
            and all(stem_smem_bytes(c, vn, kh=kh, kw=kw, stride=stride,
                                    dilation=dilation, layout=layout)
                    <= STEM_MAX_SMEM for layout in ("halo", "stack")))


# The generic body (csrc/vsconv.cu, namespace gen): tiles of 64 or 128
# output pixels, vk <= 32, a 3-stage ring; a split chunk takes at least 2
# stored steps.
CONV_ROWS = (64, 128)
CONV_MIN_CHUNK = 2
CONV_STAGES = 3
MAX_VK = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_fast(vk: int, vn: int) -> bool:
    """True for the generic body's fast instantiations (the main path's
    vk 32 with vn 64 or 128); any other vk <= 32, vn <= 128 takes its
    general one (64-row tiles, tiles zero-padded to 32 x 128)."""
    return vk == MAX_VK and vn in (64, 128)


def conv_plan(m: int, nb: int, s_steps: int, vk: int, vn: int, *,
              int8: bool = False) -> tuple[int, int]:
    """(rows, splits) of the generic body for a conv of m = N*Hout*Wout
    output pixels, NB strips of S stored (vk, vn) tiles: a pure function of
    the shapes, as `vsmm_plan` is.

    rows: 128 where the 128-row tiles x NB reach TARGET_BLOCKS (two
    blocks an SM) and the shape has a fast instantiation, else 64.
    splits: 1 where the row tiles x NB fill the SMs; otherwise as many
    chunks of at least CONV_MIN_CHUNK steps as keep the blocks within
    TARGET_BLOCKS.  int8 splits only under vsmm's exact-sum rule: never
    where a chunk's exact int32 sum could overflow (128^2 * vk * S >=
    2^31)."""
    rows = (128 if conv_fast(vk, vn) and _cdiv(m, 128) * nb >= TARGET_BLOCKS
            else 64)
    blocks = _cdiv(m, rows) * nb
    splits = 1
    if blocks < SMS:
        splits = max(1, min(TARGET_BLOCKS // blocks,
                            s_steps // CONV_MIN_CHUNK))
    if int8 and 128 * 128 * vk * s_steps >= 2 ** 31:
        splits = 1
    return rows, splits


def conv_smem_bytes(rows: int, vk: int, vn: int, *, int8: bool = False
                    ) -> int:
    """Dynamic shared memory of one generic-body block: 3 stages of a
    stored tile (f32: 32 rows of 64 or 128 floats; int8: 64 or 128
    columns of 48 bytes, k transposed) and the gathered activations (f32:
    rows of 36 floats; int8: rows of 48 bytes)."""
    wide = not conv_fast(vk, vn) or vn == 128
    if int8:
        stage = 48 * (128 if wide else 64) + 48 * rows
    else:
        stage = 4 * MAX_VK * (128 if wide else 64) + 4 * rows * 36
    return CONV_STAGES * stage


def stack_kernel_cost(
    *, n: int, hop: int, w_out: int, bw: int, bh: int, nb: int, s_steps: int,
    vk: int, vn: int, in_itemsize: int = 4, w_itemsize: int = 4,
    out_itemsize: int = 4, residual_bytes: int = 0,
) -> dict[str, int]:
    """TPU cost model of the reference's stack kernel (not the CUDA
    kernel's cost; the stack build is not counted): every sparse step
    changes the (plane, cin-tile) block, so a (bh, bw, vk) input block is
    fetched on each of the NB*S steps per row-block."""
    hb = hop // bh
    return {
        "flops": 2 * n * hop * w_out * nb * s_steps * vk * vn,
        "bytes_accessed": (
            n * hb * nb * s_steps * bh * bw * vk * in_itemsize
            + nb * s_steps * vk * vn * w_itemsize
            + n * hop * w_out * nb * vn * out_itemsize
            + residual_bytes
        ),
    }


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


def stack_layout_dims(h: int, w: int, *, kh: int, kw: int, stride: int,
                      dilation: int, h_out: int, sublane: int = 8
                      ) -> tuple[int, int]:
    """(planes, bW) of `build_row_tap_stack`'s buffer."""
    wo, _, _ = same_pads(w, kw, stride, dilation)
    bw = -(-(wo + ((kw - 1) * dilation) // stride) // sublane) * sublane
    return kh * stride, bw


def build_row_tap_stack(
    x: torch.Tensor,
    *,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    dilation: int = 1,
    h_out: int | None = None,
    sublane: int = 8,
) -> torch.Tensor:
    """NHWC -> (N, kh*stride, Hout, bW, C) row-tap/phase stack (SAME).

    Plane ``ky*stride + phase`` holds padded rows ``ky*dilation +
    stride*i`` and padded columns ``phase + stride*j'``: kh*stride
    output-sized planes, materialized.  The padded input reaches
    ``stride*bW`` columns so that every phase plane has bW of them (the
    reference's layout, kept byte-for-byte).  ``h_out`` rounds Hout up
    (extra rows read zero padding).
    """
    n, h, w, c = x.shape
    ho, pt, _ = same_pads(h, kh, stride, dilation)
    _, pl, _ = same_pads(w, kw, stride, dilation)
    ho = h_out or ho
    _, bw = stack_layout_dims(h, w, kh=kh, kw=kw, stride=stride,
                              dilation=dilation, h_out=ho, sublane=sublane)
    rows_needed = stride * (ho - 1) + (kh - 1) * dilation + 1
    cols_needed = stride * bw
    xp = F.pad(x, (0, 0, pl, max(cols_needed - w - pl, 0),
                   pt, max(rows_needed - h - pt, 0)))
    planes = [
        xp[:, ky * dilation: ky * dilation + stride * (ho - 1) + 1: stride,
           phase::stride][:, :, :bw]
        for ky in range(kh)
        for phase in range(stride)
    ]
    return torch.stack(planes, dim=1).contiguous()


def halo_h_out(shape: Sequence[int], *, w_out: int, kh: int, kw: int,
               stride: int, dilation: int) -> int:
    """Hout of a conv over a halo buffer (N, rows, bW, CB, vk); raises
    where a tap would read outside it."""
    _, rows, bw, _, _ = shape
    ke_h = (kh - 1) * dilation + 1
    ke_w = (kw - 1) * dilation + 1
    if rows < ke_h or (rows - ke_h) % stride:
        raise ValueError(f"halo rows {rows} do not fit kh={kh} "
                         f"dilation={dilation} stride={stride}")
    if stride * (w_out - 1) + ke_w > bw:
        raise ValueError(f"w_out={w_out} reads past the halo width {bw}")
    return (rows - ke_h) // stride + 1


def stack_h_out(shape: Sequence[int], *, w_out: int, kh: int, kw: int,
                stride: int, dilation: int) -> int:
    """Hout of a conv over a row-tap stack (N, kh*stride, Hout, bW, C);
    raises where the planes do not match the taps or a tap's column offset
    would read past bW."""
    _, planes, h_out, bw, _ = shape
    if planes != kh * stride:
        raise ValueError(f"stack of {planes} planes, expected "
                         f"kh*stride = {kh * stride}")
    if ((kw - 1) * dilation) // stride + w_out > bw:
        raise ValueError(f"w_out={w_out} with kw={kw} dilation={dilation} "
                         f"reads past the stack width {bw}")
    return h_out


def stack_patches(xt: torch.Tensor, *, kh: int, kw: int, stride: int,
                  dilation: int, w_out: int) -> torch.Tensor:
    """Stack (N, kh*stride, H, bW, C) -> (N, H, w_out, kh*kw*C) patches in
    (ky, kx, c) order: tap (ky, kx) is plane ``ky*stride + (kx*d) %
    stride`` from column ``(kx*d) // stride``."""
    cols = []
    for ky in range(kh):
        for kx in range(kw):
            plane = ky * stride + (kx * dilation) % stride
            off = (kx * dilation) // stride
            cols.append(xt[:, plane, :, off:off + w_out])
    return torch.cat(cols, dim=-1)


def _group_split(c: int, vk: int, vs: VectorSparse, *, kh: int, kw: int,
                 groups: int) -> tuple[int, int]:
    """(cbg, spg): cin tiles of ``vk`` per group and strips per group of a
    (grouped) conv over ``c`` input channels; raises where the channels or
    the weight do not match."""
    nb = vs.n_strips
    cb = c // vk
    if c % vk or groups < 1 or cb % groups or nb % groups:
        raise ValueError(f"{c} channels in tiles of {vk} and {nb} strips "
                         f"do not split into {groups} groups")
    cbg = cb // groups
    if vs.vk != vk or vs.shape[0] != kh * kw * cbg * vk:
        raise ValueError(f"weight {vs.shape} (vk={vs.vk}) does not match a "
                         f"{kh}x{kw} conv over {c} channels in tiles of "
                         f"{vk} in {groups} groups")
    return cbg, nb // groups


def vsconv_plain(
    xh: torch.Tensor,
    vs: VectorSparse,
    *,
    w_out: int,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version of the halo kernel on the same halo
    input: the taps are cut out of the padded buffer (im2col) and the
    structural `vsmm_plain` multiplies the stored tiles, per group.  Runs
    on any device.  It never skips (``skip_zero_inputs`` is taken for the
    kernel's signature)."""
    del skip_zero_inputs
    h_out = halo_h_out(xh.shape, w_out=w_out, kh=kh, kw=kw, stride=stride,
                       dilation=dilation)
    n, rows, bw, cb, vk = xh.shape
    _group_split(cb * vk, vk, vs, kh=kh, kw=kw, groups=groups)
    patches = tap_patches(xh.reshape(n, rows, bw, cb * vk), kh=kh, kw=kw,
                          stride=stride, dilation=dilation, h_out=h_out,
                          w_out=w_out)
    return patch_conv(patches, vs, taps=kh * kw, groups=groups, bias=bias,
                      residual=residual, scale=scale, fuse_relu=fuse_relu)


def vsconv_stack_plain(
    xt: torch.Tensor,
    vs: VectorSparse,
    *,
    w_out: int,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version of the stack kernel on the same stack:
    each tap's plane and column window cut out (`stack_patches`), then the
    structural product per group.  Runs on any device and never skips."""
    del skip_zero_inputs
    stack_h_out(xt.shape, w_out=w_out, kh=kh, kw=kw, stride=stride,
                dilation=dilation)
    _group_split(xt.shape[-1], vs.vk, vs, kh=kh, kw=kw, groups=groups)
    patches = stack_patches(xt, kh=kh, kw=kw, stride=stride,
                            dilation=dilation, w_out=w_out)
    return patch_conv(patches, vs, taps=kh * kw, groups=groups, bias=bias,
                      residual=residual, scale=scale, fuse_relu=fuse_relu)


def _conv_kernel(fn: str, x: torch.Tensor, vs: VectorSparse, *, h_out: int,
                 w_out: int, d0: int, bw: int, c: int, vk: int, kh: int,
                 kw: int, stride: int, dilation: int, groups: int,
                 bias: torch.Tensor | None, residual: torch.Tensor | None,
                 scale: torch.Tensor | None, fuse_relu: bool,
                 skip_zero_inputs: bool
                 ) -> tuple[torch.Tensor, bool, bool]:
    """Checks and launch shared by the halo and the stack kernel; ``d0``
    is the buffer's second dimension (halo rows or stack planes).  Returns
    the output, whether the stem body ran and whether the int8 branch
    did."""
    cbg, spg = _group_split(c, vk, vs, kh=kh, kw=kw, groups=groups)
    n = x.shape[0]
    nb, s_steps, _, vn = vs.vals.shape
    cout = nb * vn
    if vn > MAX_VN:
        raise ValueError(f"{fn} takes vn <= {MAX_VN}, got {vn}")
    if vk > MAX_VK:
        raise ValueError(f"{fn} takes vk <= {MAX_VK}, got {vk}")
    out_shape = (n, h_out, w_out, cout)
    check_epilogue(bias=bias, scale=scale, residual=residual, cout=cout,
                   out_shape=out_shape)
    int8 = check_operands({"x": x, "vals": vs.vals, "idx": vs.idx,
                           "bias": bias, "scale": scale,
                           "residual": residual}, x.device)
    stem = use_stem_body(c, vk, groups, kh, kw, vn, stride=stride,
                         dilation=dilation, int8=int8)
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    if out.numel():
        ints = (n, d0, bw, c // vk, h_out, w_out, kw, stride, dilation, nb,
                s_steps, vk, vn, cbg, spg, int(fuse_relu),
                int(skip_zero_inputs))
        if stem:
            aligned = x.data_ptr() % 16 == 0 and vs.vals.data_ptr() % 16 == 0
            launch("vsconv", entry_name(fn.replace("_launch", "_stem_launch"),
                                        int8),
                   (x, vs.vals, vs.idx, scale, bias, residual, out),
                   ints + (kh, int(aligned)), x.device)
        else:
            m = n * h_out * w_out
            rows, splits = conv_plan(m, nb, s_steps, vk, vn, int8=int8)
            work = None
            if splits > 1:  # each chunk's partial: f32, or int8's (T_c, A_c)
                work = torch.empty((splits, m, cout, 2) if int8
                                   else (splits, m, cout),
                                   dtype=torch.int32 if int8
                                   else torch.float32, device=x.device)
            launch("vsconv", entry_name(fn, int8),
                   (x, vs.vals, vs.idx, scale, bias, residual, out, work),
                   ints + (rows, splits), x.device)
    return out, stem, int8


def vsconv_halo_kernel(
    xh: torch.Tensor,
    vs: VectorSparse,
    *,
    w_out: int,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """Direct input xh (N, rows, bW, CB, vk) * sparse (kh*kw*CB*vk/groups,
    Cout) -> (N, Hout, w_out, Cout) f32 with Hout = (rows - ke_h) // stride
    + 1.

    CUDA tensors launch ``vsconv_halo_kernel`` of ``csrc/vsconv.cu`` on the
    current stream (built at first use); CPU tensors run `vsconv_plain`.
    ``bias``/``scale`` are (Cout,), ``residual`` (N, Hout, w_out, Cout).
    int8 ``xh`` and ``vs.vals`` with a ``scale`` launch the int8 branch of
    the body the conv takes (counted on ``int8_launches`` too).
    ``skip_zero_inputs=False`` turns the input-side skip off.
    """
    kw_ = dict(w_out=w_out, kh=kh, kw=kw, stride=stride, dilation=dilation,
               groups=groups, bias=bias, residual=residual, scale=scale,
               fuse_relu=fuse_relu, skip_zero_inputs=skip_zero_inputs)
    if xh.device.type == "cpu":
        return vsconv_plain(xh, vs, **kw_)
    if xh.device.type != "cuda":
        raise ValueError(f"vsconv_halo_kernel runs on cuda or cpu, "
                         f"not {xh.device}")
    h_out = halo_h_out(xh.shape, w_out=w_out, kh=kh, kw=kw, stride=stride,
                       dilation=dilation)
    _, rows, bw, cb, vk = xh.shape
    out, stem, int8 = _conv_kernel("vsconv_halo_launch", xh, vs,
                                   h_out=h_out, d0=rows, bw=bw, c=cb * vk,
                                   vk=vk, **kw_)
    vsconv_halo_kernel.launches += 1
    vsconv_halo_kernel.stem_launches += int(stem)
    vsconv_halo_kernel.int8_launches += int(int8)
    return out


vsconv_halo_kernel.launches = 0  # type: ignore[attr-defined]
vsconv_halo_kernel.stem_launches = 0  # type: ignore[attr-defined]
vsconv_halo_kernel.int8_launches = 0  # type: ignore[attr-defined]


def vsconv_stack_kernel(
    xt: torch.Tensor,
    vs: VectorSparse,
    *,
    w_out: int,
    kh: int = 3,
    kw: int = 3,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """Row-tap stack xt (N, kh*stride, Hout, bW, C) * sparse
    (kh*kw*C/groups, Cout) -> (N, Hout, w_out, Cout) f32.

    CUDA tensors launch ``vsconv_stack_kernel`` of ``csrc/vsconv.cu`` on
    the current stream (built at first use); CPU tensors run
    `vsconv_stack_plain`.  ``bias``/``scale`` are (Cout,), ``residual``
    (N, Hout, w_out, Cout).  int8 ``xt`` and ``vs.vals`` with a ``scale``
    launch the int8 branch of the body the conv takes (counted on
    ``int8_launches`` too).  ``skip_zero_inputs=False`` turns the
    input-side skip off.
    """
    kw_ = dict(w_out=w_out, kh=kh, kw=kw, stride=stride, dilation=dilation,
               groups=groups, bias=bias, residual=residual, scale=scale,
               fuse_relu=fuse_relu, skip_zero_inputs=skip_zero_inputs)
    if xt.device.type == "cpu":
        return vsconv_stack_plain(xt, vs, **kw_)
    if xt.device.type != "cuda":
        raise ValueError(f"vsconv_stack_kernel runs on cuda or cpu, "
                         f"not {xt.device}")
    h_out = stack_h_out(xt.shape, w_out=w_out, kh=kh, kw=kw, stride=stride,
                        dilation=dilation)
    _, planes, _, bw, c = xt.shape
    out, stem, int8 = _conv_kernel("vsconv_stack_launch", xt, vs,
                                   h_out=h_out, d0=planes, bw=bw, c=c,
                                   vk=vs.vk, **kw_)
    vsconv_stack_kernel.launches += 1
    vsconv_stack_kernel.stem_launches += int(stem)
    vsconv_stack_kernel.int8_launches += int(int8)
    return out


vsconv_stack_kernel.launches = 0  # type: ignore[attr-defined]
vsconv_stack_kernel.stem_launches = 0  # type: ignore[attr-defined]
vsconv_stack_kernel.int8_launches = 0  # type: ignore[attr-defined]
