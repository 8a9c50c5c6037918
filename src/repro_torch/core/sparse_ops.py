"""Structural vector-sparse ops (plain PyTorch path) + dispatch to kernels.

The plain path multiplies only the stored tiles (a per-step gather and a
batched product), so its FLOPs drop with density as the paper's cycle count
does.  It is the port's CPU path and the yardstick the CUDA kernels are
held against on the card.

impl (the reference's words):
  'plain' | 'jnp'          -- the structural PyTorch path, on any device
  'pallas' | 'pallas-halo' -- the hand-written CUDA kernels (`kernels.ops`);
                              for convs the halo direct-input layout.  On a
                              CPU tensor a kernel wrapper runs its plain
                              version instead
  'pallas-stack'           -- the same kernels, convs over the materialized
                              row-tap stack layout (the oracle/fallback)
  'auto'                   -- the kernels (halo) for CUDA tensors, plain
                              otherwise
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels.vsmm import _epilogue, vsmm_plain

__all__ = [
    "same_pads", "im2col", "tap_patches", "vs_matmul", "vs_conv2d",
    "dense_conv2d", "conv_weight_to_matrix", "is_depthwise", "patch_conv",
    "tap_matrix_width", "im2col_3x3", "vs_conv2d_3x3", "dense_conv2d_3x3",
]


def same_pads(size: int, k: int, stride: int,
              dilation: int = 1) -> tuple[int, int, int]:
    """XLA-"SAME" geometry: (out_size, pad_low, pad_high).

    ``dilation`` spaces the kernel taps, so the effective kernel extent is
    ``(k - 1) * dilation + 1``.  The padding may be asymmetric (the high
    side gets the odd element), which PyTorch's symmetric ``padding=``
    cannot express: callers pad explicitly with `F.pad`.
    """
    out = -(-size // stride)
    ke = (k - 1) * dilation + 1
    total = max((out - 1) * stride + ke - size, 0)
    lo = total // 2
    return out, lo, total - lo


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl in ("plain", "jnp"):
        return False
    if impl in ("pallas", "pallas-halo", "pallas-stack"):
        return True
    if impl == "auto":
        return x.is_cuda
    raise ValueError(f"unknown impl {impl!r}")


def _conv_impl(impl: str) -> str:
    """The conv kernels' input layout for a public impl string."""
    return "stack" if impl == "pallas-stack" else "halo"


def is_depthwise(groups: int, c: int, vs: VectorSparse, kh: int,
                 kw: int) -> bool:
    """Multiplier-1 depthwise: groups == C and the (kh*kw, C) tap matrix.
    A channel-multiplier conv (cout > cin) takes the grouped path."""
    return groups > 1 and groups == c and vs.shape == (kh * kw, c)


def vs_matmul(
    x: torch.Tensor,
    vs: VectorSparse,
    *,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
    impl: str = "plain",
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """x (..., K) @ sparse W (K, N) -> (..., N).

    FLOPs = density * dense FLOPs (the weight-side skip).  ``bias`` (N,),
    ``residual`` (..., N) and ``fuse_relu`` run the epilogue in f32 after
    the accumulation (residual before the ReLU — the ResNet shortcut); the
    kernel path fuses it and also skips all-zero activation tiles unless
    ``skip_zero_inputs`` is False (the paper's dense-input mode: the same
    output).  The plain path never skips.

    INT8 (int8 ``x`` and ``vs.vals``, ``scale`` (N,)): each stored step's
    partial is an exact integer, added into the f32 accumulator in stored
    order; the epilogue dequantizes first (x scale -> + bias -> + residual
    -> ReLU) and the output is f32.
    """
    *batch, k = x.shape
    if k != vs.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match W {vs.shape}")
    x2 = x.reshape(-1, k)
    res2 = None if residual is None else residual.reshape(-1, vs.shape[1])
    if _use_kernel(impl, x):
        from repro_torch.kernels import ops as kops  # lazy: import cycle

        y = kops.vsmm(x2, vs, bias=bias, residual=res2, scale=scale,
                      fuse_relu=fuse_relu, skip_zero_inputs=skip_zero_inputs)
    else:
        y = vsmm_plain(x2, vs, bias=bias, residual=res2, scale=scale,
                       fuse_relu=fuse_relu)
    return y.reshape(*batch, vs.shape[1])


def tap_patches(xp: torch.Tensor, *, kh: int, kw: int, stride: int,
                dilation: int, h_out: int, w_out: int) -> torch.Tensor:
    """Already-padded NHWC -> (N, h_out, w_out, kh*kw*C) patches, (ky, kx)
    row-major: tap (ky, kx) of output pixel (i, j) reads padded pixel
    (ky*dilation + stride*i, kx*dilation + stride*j)."""
    cols = [
        xp[:, ky * dilation: ky * dilation + stride * (h_out - 1) + 1: stride,
           kx * dilation: kx * dilation + stride * (w_out - 1) + 1: stride]
        for ky in range(kh)
        for kx in range(kw)
    ]
    return torch.cat(cols, dim=-1)


def im2col(x: torch.Tensor, *, kh: int = 3, kw: int = 3, stride: int = 1,
           dilation: int = 1) -> torch.Tensor:
    """NHWC, SAME padding -> (N, Hout, Wout, kh*kw*C) patches in the
    (ky, kx, cin) order `conv_weight_to_matrix` flattens weights into."""
    _, h, w, _ = x.shape
    ho, pt, pb = same_pads(h, kh, stride, dilation)
    wo, pl, pr = same_pads(w, kw, stride, dilation)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    return tap_patches(xp, kh=kh, kw=kw, stride=stride, dilation=dilation,
                       h_out=ho, w_out=wo)


def tap_matrix_width(vs: VectorSparse, taps: int, c: int) -> int:
    """vc of a depthwise (taps, C) tap matrix encoded vk = 1 whose strips
    are the C / vc channel tiles; raises where the weight does not match."""
    nb, _, vk, vc = vs.vals.shape
    if vk != 1 or vs.shape != (taps, c) or nb * vc != c:
        raise ValueError(f"tap matrix {vs.shape} (tiles {vk}x{vc}, {nb} "
                         f"strips) does not match {taps} taps x {c} "
                         f"channels")
    return vc


def _grouped_patch_matmul(flat: torch.Tensor, vs: VectorSparse, *,
                          taps: int, groups: int) -> torch.Tensor:
    """(M, taps*C) @ the (taps*C/groups, Cout) weight -> (M, Cout) f32:
    one `vsmm_plain` per group over its channel slice."""
    m = flat.shape[0]
    c = flat.shape[1] // taps
    cin_g = c // groups
    nb = vs.n_strips
    if c % groups or nb % groups or vs.shape[0] != taps * cin_g:
        raise ValueError(f"weight {vs.shape} ({nb} strips) does not match "
                         f"{taps} taps x {c} channels in {groups} groups")
    spg = nb // groups
    pg = flat.reshape(m, taps, groups, cin_g)
    outs = []
    for g in range(groups):
        sub = VectorSparse(vals=vs.vals[g * spg:(g + 1) * spg],
                           idx=vs.idx[g * spg:(g + 1) * spg],
                           shape=(taps * cin_g, spg * vs.vn))
        outs.append(vsmm_plain(
            pg[:, :, g].reshape(m, taps * cin_g).float(), sub))
    return torch.cat(outs, dim=-1)


def _depthwise_tap_mac(flat: torch.Tensor, vs: VectorSparse, *,
                       taps: int) -> torch.Tensor:
    """(M, taps*C) through the (taps, C) tap matrix -> (M, C) f32, step by
    step: step s multiplies each channel tile j's input at tap idx[j, s]
    elementwise by its stored tap vector."""
    m = flat.shape[0]
    c = flat.shape[1] // taps
    vc = tap_matrix_width(vs, taps, c)
    nb, s_steps = vs.idx.shape
    p4 = flat.float().reshape(m, taps, nb, vc)
    idx = vs.idx.long()
    strips = torch.arange(nb, device=flat.device)
    vals = vs.vals.float()
    acc = torch.zeros((m, nb, vc), dtype=torch.float32, device=flat.device)
    for s in range(s_steps):
        acc += p4[:, idx[:, s], strips] * vals[:, s, 0]
    return acc.reshape(m, c)


def patch_conv(patches: torch.Tensor, vs: VectorSparse, *, taps: int,
               groups: int = 1, depthwise: bool = False,
               bias: torch.Tensor | None = None,
               residual: torch.Tensor | None = None,
               scale: torch.Tensor | None = None,
               fuse_relu: bool = False) -> torch.Tensor:
    """(N, H, W, taps*C) patches in (tap, c) order through the sparse conv
    weight, epilogue after -> (N, H, W, Cout) f32.  The structural product
    every plain conv path shares; only the stored tiles are multiplied:

    * ungrouped: `vsmm_plain` over the (taps*C, Cout) matrix;
    * grouped: strips are group-major (strip j belongs to group
      j // (NB/groups)) and their K-tiles index that group's channels, so
      each group is one `vsmm_plain` over its channel slice;
    * ``depthwise`` (groups == C, multiplier 1): the (taps, C) tap matrix
      encoded vk = 1 over vc-channel strips, ``idx[j, s]`` the bare tap id;
      step s scales each channel tile's input at its tap elementwise.
    """
    n, h, w, k = patches.shape
    flat = patches.reshape(-1, k)
    cout = vs.shape[1]
    res2 = None if residual is None else residual.reshape(-1, cout)
    if groups == 1:
        y = vsmm_plain(flat, vs, bias=bias, residual=res2, scale=scale,
                       fuse_relu=fuse_relu)
    else:
        y = (_depthwise_tap_mac(flat, vs, taps=taps) if depthwise
             else _grouped_patch_matmul(flat, vs, taps=taps, groups=groups))
        y = _epilogue(y, bias=bias, residual=res2, scale=scale,
                      fuse_relu=fuse_relu)
    return y.reshape(n, h, w, cout)


def vs_conv2d(
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
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
    impl: str = "plain",
) -> torch.Tensor:
    """kh x kw / stride / dilation / SAME conv with vector-sparse weights.

    Weight matrix layout: (kh*kw*Cin, Cout) with K ordered (ky, kx, cin).
    A 1x1 conv is the sparse matmul over pixels (stride subsamples first).
    Grouped convs take the (kh*kw*Cin/groups, Cout) matrix with strips
    group-major; depthwise (groups == Cin, multiplier 1) the (kh*kw, C) tap
    matrix encoded vk = 1 over vn-channel tiles.  ``bias``, ``residual``
    (the output-shaped ResNet shortcut, added before the ReLU) and
    ``fuse_relu`` form the epilogue.  ``impl="pallas"``/``"pallas-halo"``
    runs the kernels over the halo layout, ``"pallas-stack"`` over the
    row-tap stack.
    """
    if _use_kernel(impl, x):
        from repro_torch.kernels import ops as kops  # lazy: import cycle

        return kops.vsconv(
            x, w_vs, kh=kh, kw=kw, stride=stride, groups=groups,
            dilation=dilation, bias=bias, residual=residual, scale=scale,
            fuse_relu=fuse_relu, impl=_conv_impl(impl))
    if kh == 1 and kw == 1:
        patches = x[:, ::stride, ::stride] if stride != 1 else x
    else:
        patches = im2col(x, kh=kh, kw=kw, stride=stride, dilation=dilation)
    y = patch_conv(patches, w_vs, taps=kh * kw, groups=groups,
                   depthwise=is_depthwise(groups, x.shape[-1], w_vs, kh, kw),
                   bias=bias, residual=residual, scale=scale,
                   fuse_relu=fuse_relu)
    return y if x.dtype == torch.int8 else y.to(x.dtype)  # int8 -> f32


def im2col_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3/s1 SAME patches (the reference's back-compat alias)."""
    return im2col(x, kh=3, kw=3, stride=1)


def vs_conv2d_3x3(x: torch.Tensor, w_vs: VectorSparse, *,
                  impl: str = "plain") -> torch.Tensor:
    """3x3/s1 SAME conv with vector-sparse weights (the reference's
    back-compat alias)."""
    return vs_conv2d(x, w_vs, kh=3, kw=3, stride=1, impl=impl)


def dense_conv2d_3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense 3x3/s1 oracle (the reference's back-compat alias)."""
    return dense_conv2d(x, w, stride=1)


def dense_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """Dense oracle: x NHWC, w (kh, kw, Cin/groups, Cout), SAME padding.

    On CUDA this is cuDNN, which runs f32 convolutions in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False: callers comparing at f32
    tolerance turn it off.
    """
    kh, kw = w.shape[:2]
    _, h, wd, _ = x.shape
    _, pt, pb = same_pads(h, kh, stride, dilation)
    _, pl, pr = same_pads(wd, kw, stride, dilation)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride,
                 dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_weight_to_matrix(w: torch.Tensor) -> torch.Tensor:
    """(kh,kw,Cin,Cout) -> (kh*kw*Cin, Cout) in the im2col (ky,kx,cin) order."""
    kh, kw, cin, cout = w.shape
    return w.reshape(kh * kw * cin, cout)
