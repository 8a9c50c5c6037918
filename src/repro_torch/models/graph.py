"""Network IR + graph executor: whole networks on the vector-sparse path.

A network is data — a `SparseNet` holding a flat tuple of `LayerSpec`s —
and one walker (`net_apply`) runs it dense or sparse; `sparsify` folds BN
into the conv weights, vector-prunes every conv and FC layer and encodes
them for the kernels.  The port of `repro/models/graph.py`, f32 and int8:
ungrouped, grouped and depthwise convs.

LayerSpec vocabulary
--------------------
  Conv(name, cin, cout, kh, kw, stride, bn, relu, residual, src, dst)
      kh x kw / stride / SAME conv.  ``bn=True`` gives it inference BN
      parameters, folded into the weights and a bias by `sparsify`.
      ``residual`` names a saved slot added before the ReLU (the kernels'
      fused epilogue); ``src`` reads the input from a slot and ``dst``
      writes the output to one (the ResNet downsample projection).
  FC(name, din, dout, relu)      fully-connected (+bias, ReLU).
  Classifier(name, din, dout)    FC with relu=False — the logits head.
  Pool(kind, size, stride, padding)   'max' | 'avg' window pool or 'gap'.
  ResidualAdd(key, relu)         explicit unfused shortcut add.
  Save(key)                      checkpoint the stream into a named slot.
  Flatten()                      NHWC -> (N, features).

FC layers whose Cout does not tile (a 1000-class head) are zero-padded to
the strip width and the pad columns sliced off after the kernel — the
remainder strip.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.pruning import prune_vectors_balanced
from repro_torch.core.sparse_ops import (dense_conv2d, same_pads, vs_conv2d,
                                         vs_matmul)
from repro_torch.core.vector_sparse import (VectorSparse, conv_cin_major,
                                            from_mask)
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.capture import Captured, capture
from repro_torch.models.layers import P
from repro_torch.parallel import sharding as shd

__all__ = [
    "Conv", "FC", "Classifier", "Pool", "ResidualAdd", "Save", "Flatten",
    "SparseNet", "SparseConv", "SparseFC", "BatchedApply",
    "ConvTileGeometry", "FCTileGeometry", "TileGeometryError",
    "conv_tile_geometry", "fc_tile_geometry", "strip_steps",
    "sparse_conv_from_dense", "apply_sparse_conv", "apply_sparse_fc",
    "weight_scales", "quantize_weights_int8", "quantize_activations_int8",
    "net_schema", "net_apply", "collect_conv_traffic", "sparsify",
    "input_refusal", "output_finite",
    "place_params", "shard_sparse", "build_vgg16", "VGG16_LAYERS", "build_resnet18",
    "RESNET18_STAGES", "build_resnet34", "RESNET34_STAGES", "build_resnet50",
    "RESNET50_STAGES", "build_mobilenet_v1", "MOBILENET_V1_PLAN",
    "build_resnet_stem", "BN_EPS",
]

BN_EPS = 1e-5


# --------------------------------------------------------------------------
# Layer specs (the IR)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Conv:
    """kh x kw / stride / dilation / SAME (grouped) conv (+BN) (+residual)
    (+ReLU).  ``allow_fallback`` accepts a channel-multiplier depthwise
    conv (rule VSC109)."""

    name: str
    cin: int
    cout: int
    kh: int = 3
    kw: int = 3
    stride: int = 1
    groups: int = 1
    dilation: int = 1
    bn: bool = False
    relu: bool = True
    residual: str | None = None  # slot added before ReLU (fused epilogue)
    src: str | None = None       # read input from slot, not the stream
    dst: str | None = None       # write output to slot, leave stream as-is
    allow_fallback: bool = False


@dataclasses.dataclass(frozen=True)
class FC:
    """Fully-connected layer: x @ W + b (+ReLU)."""

    name: str
    din: int
    dout: int
    relu: bool = True


def Classifier(name: str, din: int, dout: int) -> FC:
    """The logits head: an FC without the ReLU."""
    return FC(name, din, dout, relu=False)


@dataclasses.dataclass(frozen=True)
class Pool:
    """'max' | 'avg' window pool, or 'gap' (global average pool)."""

    kind: str = "max"
    size: int = 2
    stride: int | None = None  # None -> size
    padding: str = "VALID"


@dataclasses.dataclass(frozen=True)
class ResidualAdd:
    """Explicit (unfused) shortcut add: x = [relu](x + saved[key])."""

    key: str
    relu: bool = True


@dataclasses.dataclass(frozen=True)
class Save:
    """Checkpoint the stream into a named slot."""

    key: str


@dataclasses.dataclass(frozen=True)
class Flatten:
    """NHWC -> (N, features)."""


@dataclasses.dataclass(frozen=True)
class SparseNet:
    """A network as data: a name and a flat tuple of LayerSpecs."""

    name: str
    layers: tuple

    def schema(self) -> dict:
        return net_schema(self)

    def sparsify(self, params: dict, density: float, *, vk: int = 32,
                 vn: int = 128, include_fc: bool = True,
                 dtype: Any = None) -> tuple[dict, dict]:
        return sparsify(self, params, density, vk=vk, vn=vn,
                        include_fc=include_fc, dtype=dtype)

    def conv_layers(self) -> list[Conv]:
        return [l for l in self.layers if isinstance(l, Conv)]

    def fc_layers(self) -> list[FC]:
        return [l for l in self.layers if isinstance(l, FC)]


# --------------------------------------------------------------------------
# Sparse layer entries (what `sparsify` produces, what the walker consumes)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SparseConv:
    """One vector-sparse conv layer: weights + geometry.

    ``cin_pad`` zero channels are appended to the input before the conv
    (how the 3-channel stem becomes a multiple of the K-tile length; the
    padded weight rows are zero).  ``bias`` (when set) overrides the
    param-tree bias — the BN-folded bias lives here.  ``scale`` is the int8
    per-cout dequant scale (None in f32).
    """

    vs: VectorSparse
    kh: int = 3
    kw: int = 3
    stride: int = 1
    groups: int = 1
    dilation: int = 1
    cin_pad: int = 0
    bias: torch.Tensor | None = None
    scale: torch.Tensor | None = None


@dataclasses.dataclass
class SparseFC:
    """One vector-sparse FC layer.  ``dout`` is the true output width; the
    encoded matrix may carry remainder-strip zero columns."""

    vs: VectorSparse
    dout: int | None = None
    bias: torch.Tensor | None = None
    scale: torch.Tensor | None = None


# --------------------------------------------------------------------------
# Tile geometry
# --------------------------------------------------------------------------

class TileGeometryError(ValueError):
    """A layer whose weights have no valid vector-sparse encoding.

    ``rule`` is the reference analyzer's rule id (e.g. ``VSC109``)."""

    def __init__(self, rule: str, path: str, message: str, hint: str = ""):
        self.rule, self.path, self.message, self.hint = (rule, path, message,
                                                         hint)
        super().__init__(f"{rule} {path}: {message}"
                         + (f" (hint: {hint})" if hint else ""))


def _largest_divisor(n: int, cap: int) -> int:
    """The largest divisor of ``n`` that is <= ``cap``."""
    d = min(cap, n)
    while n % d:
        d -= 1
    return d


@dataclasses.dataclass(frozen=True)
class ConvTileGeometry:
    """How one conv layer's weights encode: encoded tile dims ``vk``/``vn``,
    ``cin_pad`` zero input channels, ``kb`` K-tiles and ``nb`` strips."""

    depthwise: bool
    vk: int
    vn: int
    cin_pad: int
    kb: int
    nb: int


@dataclasses.dataclass(frozen=True)
class FCTileGeometry:
    """FC encoding geometry: ``pad`` zero output columns (the remainder
    strip), ``kb`` K-tiles, ``nb`` output strips."""

    vk: int
    vn: int
    pad: int
    kb: int
    nb: int


def conv_tile_geometry(
    kh: int, kw: int, cin_g: int, cout: int, *, vk: int = 32, vn: int = 128,
    groups: int = 1, allow_fallback: bool = False, path: str = "conv",
) -> ConvTileGeometry:
    """Tile geometry of a (kh, kw, cin/groups, cout) conv weight.

    Ungrouped: when cin does not tile, the K-tile shrinks to min(vk, 8) and
    the channels are zero-padded to its multiple; the strip shrinks to the
    largest divisor of cout <= vn.  Grouped: K-tiles stay inside the group.
    Depthwise: the (kh*kw, C) tap matrix with vk == 1.  A channel-multiplier
    depthwise conv raises `TileGeometryError` (rule VSC109) unless
    ``allow_fallback``.
    """
    depthwise = groups > 1 and cin_g == 1 and cout == groups
    if depthwise:
        vn_l = _largest_divisor(cout, vn)
        return ConvTileGeometry(depthwise=True, vk=1, vn=vn_l, cin_pad=0,
                                kb=kh * kw, nb=cout // vn_l)
    if groups > 1 and cin_g == 1 and not allow_fallback:
        raise TileGeometryError(
            "VSC109", path,
            f"depthwise channel-multiplier {cout // groups} > 1 "
            f"(groups={groups}, cout={cout}) has no per-channel tap "
            f"encoding and would run grouped kernels with vk == 1",
            hint="set Conv(allow_fallback=True) to accept the vk==1 "
                 "grouped fallback, or split into depthwise + 1x1")
    if groups > 1:
        vk_l = _largest_divisor(cin_g, vk)
        cp = 0
        vn_l = _largest_divisor(cout // groups, vn)
    else:
        if cin_g % vk == 0:
            vk_l, cp = vk, 0
        else:
            vk_l = min(vk, 8)
            cp = -cin_g % vk_l
        vn_l = _largest_divisor(cout, vn)
    return ConvTileGeometry(
        depthwise=False, vk=vk_l, vn=vn_l, cin_pad=cp,
        kb=kh * kw * (cin_g + cp) // vk_l, nb=cout // vn_l)


def fc_tile_geometry(din: int, dout: int, *, vk: int = 32, vn: int = 128
                     ) -> FCTileGeometry | None:
    """FC encoding geometry, or None when the layer stays dense (fan-in not
    a vk multiple)."""
    if din % vk:
        return None
    vn_l = min(vn, dout)
    pad = -dout % vn_l
    return FCTileGeometry(vk=vk, vn=vn_l, pad=pad, kb=din // vk,
                          nb=(dout + pad) // vn_l)


def strip_steps(kb: int, density: float, *, prune: bool = True) -> int:
    """Stored tiles per strip after balanced pruning — the S axis."""
    if not prune or density >= 1.0:
        return kb
    return max(1, int(round(kb * density)))


# --------------------------------------------------------------------------
# INT8 quantization (compound sparsity x precision)
# --------------------------------------------------------------------------

def _np_dtype(dtype: Any) -> np.dtype | None:
    """``dtype`` (a string, numpy or torch dtype) as a numpy dtype; None
    where numpy has no such dtype."""
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    try:
        return np.dtype(dtype)
    except TypeError:
        return None


def _wants_int8(dtype: Any) -> bool:
    """True iff ``dtype`` names int8 (a string, a numpy or a torch dtype)."""
    return dtype is not None and _np_dtype(dtype) == np.dtype(np.int8)


def _encode_int8(dtype: Any) -> bool:
    """True for an int8 encoding, False for f32 (None or float32); raises
    for any other dtype, which the port does not encode."""
    if dtype is None or _np_dtype(dtype) == np.dtype(np.float32):
        return False
    if _wants_int8(dtype):
        return True
    raise NotImplementedError(
        f"dtype={dtype!r}: the port encodes float32 or int8 weights only")


def _pow2_up(s: np.ndarray) -> np.ndarray:
    """Round positive scales UP to the next power of two (exact in f32), so
    every dequant multiply only shifts an exponent and the fused epilogue
    ``acc*s + bias`` gives the same bits with or without FMA contraction."""
    s64 = np.asarray(s, np.float64)
    p = np.exp2(np.ceil(np.log2(s64)))
    p = np.where(p < s64, p * 2.0, p)  # guard log2 rounding at po2 inputs
    return p.astype(np.float32)


def weight_scales(wm: np.ndarray) -> np.ndarray:
    """Per-cout symmetric int8 scales of a (K, Cout) weight matrix:
    ``max|wm[:, c]| / 127`` rounded up to a power of two; an all-zero
    column (a remainder-strip pad column) gets 1.0."""
    s = np.abs(np.asarray(wm, np.float32)).max(axis=0) / 127.0
    return _pow2_up(np.where(s > 0, s, 1.0))


def quantize_weights_int8(wm: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Symmetric round-half-to-even int8 encode of ``wm`` at per-cout
    scales ``s`` (decode is ``wq.astype(f32) * s``)."""
    q = np.rint(np.asarray(wm, np.float32) / s)
    return np.clip(q, -127, 127).astype(np.int8)


def quantize_activations_int8(x: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 activation quantization, on x's device
    and without a host sync.

    Returns ``(xq, sx)``: ``sx`` (a 0-d f32 tensor) is ``max|x| / 127``
    rounded up to a power of two (1.0 for an all-zero tensor), ``xq =
    clip(round_half_even(x / sx), -127, 127)`` as int8.  Every division
    is between two tensors: PyTorch's CUDA kernel divides by a CPU scalar
    as a multiply by its reciprocal, which is not the reference's
    quotient.
    """
    xf = x.float()
    one = torch.ones((), dtype=torch.float32, device=x.device)
    sx = xf.abs().amax() / torch.full_like(one, 127.0)
    sx = torch.where(sx > 0, sx, one)
    p = torch.exp2(torch.ceil(torch.log2(sx)))
    sx = torch.where(p < sx, p * 2, p)
    xq = torch.clamp(torch.round(xf / sx), -127, 127)
    return xq.to(torch.int8), sx


def sparse_conv_from_dense(
    w: np.ndarray | torch.Tensor,
    density: float,
    *,
    vk: int = 32,
    vn: int = 128,
    stride: int = 1,
    groups: int = 1,
    dilation: int = 1,
    prune: bool = True,
    dtype: Any = None,
    allow_fallback: bool = False,
    path: str = "conv",
    device: str | torch.device = "cpu",
) -> tuple[SparseConv, np.ndarray]:
    """Dense (kh, kw, Cin/groups, Cout) weight -> (SparseConv on ``device``,
    pruned dense numpy weight).

    Non-tileable Cin is zero-padded to a multiple of min(vk, 8); non-tileable
    Cout shrinks the strip.  ``prune=False`` (or density >= 1) keeps every
    tile.  Convs with kh*kw > 1 store their tiles cin-major.  Grouped convs
    keep K inside the group (strips group-major, per-group pruning quotas
    by construction).  Depthwise (groups == Cin, multiplier 1) encodes the
    (kh*kw, Cout) tap matrix with vk == 1 over channel-tile strips, in
    ascending tap order.

    ``dtype="int8"`` quantizes the pruned weights per cout (`weight_scales`,
    `quantize_weights_int8`): the tiles are int8, the scales go on the
    entry, and the returned dense weight is the dequantized one.
    """
    int8 = _encode_int8(dtype)
    w = np.asarray(torch.as_tensor(w).detach().cpu(), np.float32)
    kh, kw, cin_g, cout = w.shape
    g = conv_tile_geometry(kh, kw, cin_g, cout, vk=vk, vn=vn, groups=groups,
                           allow_fallback=allow_fallback, path=path)
    vk_l, vn_l, cp = g.vk, g.vn, g.cin_pad
    # depthwise: cin_g == 1 and vk_l == 1, so wm below is the (kh*kw, Cout)
    # tap matrix, one row per tap, strips over channel tiles
    wpad = np.pad(w, ((0, 0), (0, 0), (0, cp), (0, 0))) if cp else w
    wm = wpad.reshape(kh * kw * (cin_g + cp), cout)
    if prune and density < 1.0:
        wp, mask = prune_vectors_balanced(wm, density, vk_l, vn_l)
    else:
        wp = wm
        mask = np.ones((wm.shape[0] // vk_l, cout // vn_l), bool)
    scale, enc = None, wp
    if int8:
        # quantize the PRUNED weights: the scales see only surviving tiles
        scale = weight_scales(wp)
        enc = quantize_weights_int8(wp, scale)
        wp = enc.astype(np.float32) * scale  # the dequantized dense oracle
    vs = from_mask(torch.as_tensor(enc, device=device), mask, vk_l, vn_l)
    if kh * kw > 1 and not g.depthwise:
        vs = conv_cin_major(vs, (cin_g + cp) // vk_l)
    spec = SparseConv(vs, kh=kh, kw=kw, stride=stride, groups=groups,
                      dilation=dilation, cin_pad=cp,
                      scale=None if scale is None
                      else torch.as_tensor(scale, device=device))
    return spec, wp.reshape(kh, kw, cin_g + cp, cout)[:, :, :cin_g]


def apply_sparse_conv(x: torch.Tensor, entry: SparseConv | VectorSparse, *,
                      bias: torch.Tensor | None = None,
                      fuse_relu: bool = True,
                      residual: torch.Tensor | None = None,
                      impl: str = "auto") -> torch.Tensor:
    """Run one conv through the vector-sparse path (input channels padded
    by ``cin_pad`` first; ``residual`` added before the ReLU).

    An int8 entry (``spec.scale`` set) quantizes the layer input per
    tensor first, then pads cin with int8 zeros; the kernel multiplies
    int8 by int8 exactly and the combined scale ``sx * s_w`` (a power of
    two) dequantizes in the fused epilogue, before the bias."""
    spec = entry if isinstance(entry, SparseConv) else SparseConv(entry)
    if isinstance(spec.vs.vals, DTensor):
        return _sharded_conv(x, spec, bias=bias, fuse_relu=fuse_relu,
                             residual=residual, impl=impl)
    scale = spec.scale
    if scale is not None:
        x, sx = quantize_activations_int8(x)
        scale = sx * scale
    if spec.cin_pad:
        x = F.pad(x, (0, spec.cin_pad))
    return vs_conv2d(
        x, spec.vs, kh=spec.kh, kw=spec.kw, stride=spec.stride,
        groups=spec.groups, dilation=spec.dilation, bias=bias,
        residual=residual, scale=scale, fuse_relu=fuse_relu, impl=impl)


def apply_sparse_fc(x: torch.Tensor, entry: SparseFC | VectorSparse, *,
                    bias: torch.Tensor | None = None, fuse_relu: bool = False,
                    residual: torch.Tensor | None = None,
                    impl: str = "auto") -> torch.Tensor:
    """Run one FC layer through the vector-sparse path.  Bias and residual
    are padded to the encoded width (the remainder strip) and the pad
    columns sliced off after the kernel.  An int8 entry quantizes the
    input per tensor first, as `apply_sparse_conv` does."""
    spec = entry if isinstance(entry, SparseFC) else SparseFC(entry)
    if isinstance(spec.vs.vals, DTensor):
        return _sharded_fc(x, spec, bias=bias, fuse_relu=fuse_relu,
                           residual=residual, impl=impl)
    n_enc = spec.vs.shape[1]
    dout = spec.dout or n_enc
    if bias is not None and bias.shape[-1] != n_enc:
        bias = F.pad(bias, (0, n_enc - bias.shape[-1]))
    if residual is not None and residual.shape[-1] != n_enc:
        residual = F.pad(residual, (0, n_enc - residual.shape[-1]))
    scale = spec.scale
    if scale is not None:
        x, sx = quantize_activations_int8(x)
        scale = sx * scale
    y = vs_matmul(x, spec.vs, bias=bias, residual=residual, scale=scale,
                  fuse_relu=fuse_relu, impl=impl)
    return y[..., :dout] if dout != n_enc else y


def _sharded_fc(x: torch.Tensor, spec: SparseFC, *,
                bias: torch.Tensor | None, fuse_relu: bool,
                residual: torch.Tensor | None, impl: str) -> torch.Tensor:
    """An FC layer whose strips are cout-sharded over a mesh (`shard_sparse`):
    each rank runs the kernel over its own strips, with its columns of the
    bias, residual and dequant scale, and the outputs are gathered along
    the last dim (the reference's GSPMD epilogue gather); the pad columns
    go after the gather.  Every column is computed by one rank alone, so
    f32 logits are the one-device ones, bit for bit."""
    vals, idx = spec.vs.vals, spec.vs.idx
    vl, il = vals.to_local(), idx.to_local()
    n_enc, w_l = spec.vs.shape[1], vl.shape[0] * vl.shape[-1]
    mine = _my_columns(_strip_rank(vals), w_l, n_enc)
    local = SparseFC(VectorSparse(vals=vl, idx=il,
                                  shape=(spec.vs.shape[0], w_l)),
                     scale=mine(spec.scale))
    y = apply_sparse_fc(x, local, bias=mine(bias), fuse_relu=fuse_relu,
                        residual=mine(residual), impl=impl)
    y = _gather_columns(y, vals, w_l, n_enc)
    dout = spec.dout or n_enc
    return y[..., :dout] if dout != n_enc else y


def _sharded_conv(x: torch.Tensor, spec: SparseConv, *,
                  bias: torch.Tensor | None, fuse_relu: bool,
                  residual: torch.Tensor | None, impl: str) -> torch.Tensor:
    """A conv whose cout strips are sharded over a mesh (`shard_sparse`
    under a ``conv`` rule on a mesh dim), `_sharded_fc`'s counterpart:
    each rank runs the conv kernels over its own strips, a local
    `VectorSparse`, with its columns of the bias, residual and dequant
    scale, and the output channels are gathered.  A grouped or depthwise
    conv also takes only its groups' input channels (its strips cover
    whole groups, or lie inside one).  An int8 layer quantizes the
    *whole* input first (its per-tensor scale is the whole tensor's
    amax), then cuts it.  Every output column is computed by one rank
    alone, by the kernels' one-device plan for its strips."""
    vals, idx = spec.vs.vals, spec.vs.idx
    vl, il = vals.to_local(), idx.to_local()
    k_rows, n_enc = spec.vs.shape
    w_l = vl.shape[0] * vl.shape[-1]
    rank = _strip_rank(vals)
    mine = _my_columns(rank, w_l, n_enc)
    scale = spec.scale
    if scale is not None:
        x, sx = quantize_activations_int8(x)
        scale = sx * mine(scale)
    if spec.cin_pad:
        x = F.pad(x, (0, spec.cin_pad))
    groups = spec.groups
    if groups > 1 and w_l != n_enc:
        cin_g, cout_g = x.shape[-1] // groups, n_enc // groups
        g0 = rank * w_l // cout_g
        if w_l % cout_g == 0:
            groups = w_l // cout_g
        elif cout_g % w_l == 0:
            groups = 1
        else:
            raise ValueError(
                f"{w_l} columns a rank neither cover whole groups of "
                f"{cout_g} nor lie inside one")
        x = x[..., g0 * cin_g:(g0 + groups) * cin_g].contiguous()
    y = vs_conv2d(
        x, VectorSparse(vals=vl, idx=il, shape=(k_rows, w_l)), kh=spec.kh,
        kw=spec.kw, stride=spec.stride, groups=groups,
        dilation=spec.dilation, bias=mine(bias), residual=mine(residual),
        scale=scale, fuse_relu=fuse_relu, impl=impl)
    return _gather_columns(y, vals, w_l, n_enc)


def _strip_rank(vals: DTensor) -> int:
    """This rank's index among the shards of strip-sharded ``vals`` (the
    mesh dims that shard them, the first the major one), on its own
    mesh: a replica's ``("model",)`` mesh may be part of a larger
    world."""
    mesh, coord, r = vals.device_mesh, vals.device_mesh.get_coordinate(), 0
    for i, p in enumerate(vals.placements):
        if isinstance(p, Shard):
            r = r * mesh.size(i) + coord[i]
    return r


def _my_columns(rank: int, w_l: int, n_enc: int):
    """The function that cuts a rank's ``w_l`` columns out of a bias,
    scale or residual of ``n_enc`` columns (padded to them first: the
    FC remainder strip); None stays None."""
    cols = slice(rank * w_l, (rank + 1) * w_l)

    def mine(t: torch.Tensor | None) -> torch.Tensor | None:
        if t is None:
            return None
        t = t.full_tensor() if isinstance(t, DTensor) else t
        if t.shape[-1] != n_enc:
            t = F.pad(t, (0, n_enc - t.shape[-1]))
        return t[..., cols].contiguous()

    return mine


def _gather_columns(y: torch.Tensor, vals: DTensor, w_l: int,
                    n_enc: int) -> torch.Tensor:
    """Each rank's ``w_l`` output columns (the last dim) gathered over the
    mesh dims that shard ``vals``: the whole output on every rank."""
    if w_l == n_enc:
        return y
    out = [Shard(y.ndim - 1) if isinstance(p, Shard) else Replicate()
           for p in vals.placements]
    return DTensor.from_local(y.contiguous(), vals.device_mesh, out,
                              run_check=False).full_tensor()


# --------------------------------------------------------------------------
# Schema
# --------------------------------------------------------------------------

def net_schema(net: SparseNet) -> dict:
    """P-schema for `models.layers.init_params` from the layer specs (BN
    convs get identity-initialized scale/offset/mean/var, no bias)."""
    s = {}
    for l in net.layers:
        if isinstance(l, Conv):
            cin_g = l.cin // l.groups
            e = {
                "w": P((l.kh, l.kw, cin_g, l.cout), (None, None, None, "ff"),
                       fan_in=l.kh * l.kw * cin_g),
            }
            if l.bn:
                e["scale"] = P((l.cout,), ("ff",), init="ones")
                e["offset"] = P((l.cout,), ("ff",), init="zeros")
                e["mean"] = P((l.cout,), ("ff",), init="zeros")
                e["var"] = P((l.cout,), ("ff",), init="ones")
            else:
                e["b"] = P((l.cout,), ("ff",), init="zeros")
            s[l.name] = e
        elif isinstance(l, FC):
            s[l.name] = {
                "w": P((l.din, l.dout), ("fsdp", "ff"), fan_in=l.din),
                "b": P((l.dout,), ("ff",), init="zeros"),
            }
    return s


# --------------------------------------------------------------------------
# Executor
# --------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _bn_fold(p: dict) -> tuple[np.ndarray, np.ndarray]:
    """Inference BN -> (per-cout scale g, bias b): y*g + b == BN(y)."""
    g = _np(p["scale"]) / np.sqrt(_np(p["var"]) + BN_EPS)
    b = _np(p["offset"]) - _np(p["mean"]) * g
    return g, b


def _dense_conv(l: Conv, p: dict, x: torch.Tensor,
                res: torch.Tensor | None) -> torch.Tensor:
    """Dense oracle for one Conv layer (BN applied explicitly if present)."""
    y = dense_conv2d(x.float(), p["w"].float(), stride=l.stride,
                     groups=l.groups, dilation=l.dilation)
    if "scale" in p:
        g = p["scale"].float() * torch.rsqrt(p["var"].float() + BN_EPS)
        y = (y - p["mean"].float()) * g + p["offset"].float()
    elif "b" in p:
        y = y + p["b"].float()
    if res is not None:
        y = y + res.float()
    if l.relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def _pool(l: Pool, x: torch.Tensor) -> torch.Tensor:
    """NHWC window pool.  SAME padding is the reference's (asymmetric, the
    odd element high), padded explicitly: -inf for max, zeros for avg (the
    reference divides by the full window either way)."""
    if l.kind == "gap":
        return x.mean(dim=(1, 2), keepdim=True)
    stride = l.stride or l.size
    if l.padding == "SAME":
        _, pt, pb = same_pads(x.shape[1], l.size, stride)
        _, pl, pr = same_pads(x.shape[2], l.size, stride)
    elif l.padding == "VALID":
        pt = pb = pl = pr = 0
    else:
        raise ValueError(l.padding)
    fill = float("-inf") if l.kind == "max" else 0.0
    xp = F.pad(x, (0, 0, pl, pr, pt, pb), value=fill).permute(0, 3, 1, 2)
    if l.kind == "max":
        y = F.max_pool2d(xp, l.size, stride)
    elif l.kind == "avg":
        y = F.avg_pool2d(xp, l.size, stride)
    else:
        raise ValueError(l.kind)
    return y.permute(0, 2, 3, 1).contiguous()


def net_apply(net: SparseNet, params: dict, x: torch.Tensor, *,
              sparse: dict | None = None, impl: str = "auto",
              collect: list | None = None,
              collect_fc: list | None = None) -> torch.Tensor:
    """Walk the graph: x (N, H, W, C) -> logits / features.

    sparse: {layer_name: SparseConv | SparseFC | VectorSparse} — layers
    present run the vector-sparse path (kernels or the plain path, per
    ``impl``); absent layers run dense.  ``collect`` (a list) records
    (name, layer input NHWC, weight, stride, groups, dilation) per conv
    (the cycle model's input); ``collect_fc`` (a separate list, so the
    conv record keeps its shape) records (name, layer input, weight) per
    FC layer (the calibration measures FC layers on these inputs).
    """
    sparse = sparse or {}
    saved: dict[str, torch.Tensor] = {}
    for l in net.layers:
        if isinstance(l, Save):
            saved[l.key] = x
        elif isinstance(l, Conv):
            xin = saved[l.src] if l.src else x
            res = saved[l.residual] if l.residual else None
            p = params[l.name]
            if collect is not None:
                collect.append((l.name, xin, p["w"], l.stride, l.groups,
                                l.dilation))
            if l.name in sparse:
                entry = sparse[l.name]
                spec = (entry if isinstance(entry, SparseConv)
                        else SparseConv(entry))
                bias = spec.bias if spec.bias is not None else p.get("b")
                if l.bn and spec.bias is None:
                    raise ValueError(
                        f"sparse entry for BN conv {l.name!r} has no folded "
                        f"bias; build it with graph.sparsify")
                y = apply_sparse_conv(xin, spec, bias=bias,
                                      fuse_relu=l.relu, residual=res,
                                      impl=impl)
            else:
                y = _dense_conv(l, p, xin, res)
            if l.dst:
                saved[l.dst] = y
            else:
                x = y
        elif isinstance(l, ResidualAdd):
            y = x.float() + saved[l.key].float()
            if l.relu:
                y = torch.clamp_min(y, 0.0)
            x = y.to(x.dtype)
        elif isinstance(l, Pool):
            x = _pool(l, x)
        elif isinstance(l, Flatten):
            x = x.reshape(x.shape[0], -1)
        elif isinstance(l, FC):
            p = params[l.name]
            if collect_fc is not None:
                collect_fc.append((l.name, x, p["w"]))
            if l.name in sparse:
                entry = sparse[l.name]
                spec = (entry if isinstance(entry, SparseFC)
                        else SparseFC(entry))
                bias = spec.bias if spec.bias is not None else p["b"]
                x = apply_sparse_fc(x, spec, bias=bias, fuse_relu=l.relu,
                                    impl=impl)
            else:
                y = (x.float() @ p["w"].float()).to(x.dtype) + p["b"]
                x = torch.relu(y) if l.relu else y
        else:
            raise TypeError(f"unknown layer spec: {l!r}")
    return x


def collect_conv_traffic(net: SparseNet, params: dict, x: torch.Tensor, *,
                         sparse: dict | None = None,
                         impl: str = "auto") -> list:
    """Forward pass recording (name, conv input NHWC, weight, stride,
    groups, dilation) per conv layer — the input of
    `core.accel_model.network_cycle_reports` / `network_traffic_reports`.

    ``sparse`` and ``impl`` are `net_apply`'s: with the `sparsify` entries
    the recorded inputs are the sparse path's activations (the kernels' on
    CUDA tensors under ``impl="auto"``); without them the dense forward of
    ``params``.  Pass `sparsify`'s pruned tree as ``params`` so that the
    recorded weights are the pruned ones."""
    rec: list = []
    with torch.inference_mode():
        net_apply(net, params, x, sparse=sparse, impl=impl, collect=rec)
    return rec


def input_refusal(image: Any, *, max_size: int | None = None,
                  channels: int | None = None) -> str | None:
    """Admission-time validation of one serving input image: a
    machine-readable refusal reason, or None when the image is servable (a
    rank-3 float numpy array of finite values, within ``max_size``)."""
    if not isinstance(image, np.ndarray):
        return f"not_an_array:{type(image).__name__}"
    if image.ndim != 3:
        return f"bad_rank:{image.ndim}"
    if not np.issubdtype(image.dtype, np.floating):
        return f"bad_dtype:{image.dtype}"
    if image.size == 0:
        return "empty_image"
    h, w, c = image.shape
    if channels is not None and c != channels:
        return f"bad_channels:{c}"
    if max_size is not None and max(h, w) > max_size:
        return f"oversize:{h}x{w}>{max_size}"
    if not bool(np.isfinite(image).all()):
        return "non_finite_input"
    return None


def output_finite(emission: Any) -> bool:
    """True iff every value in one emission (a logits row) is finite."""
    arr = np.asarray(emission)
    if not np.issubdtype(arr.dtype, np.floating):
        return True
    return bool(np.isfinite(arr).all())


@dataclasses.dataclass
class _Bucket:
    """One shape bucket on the card: its page-locked host batch, its
    static input, and once captured its graph and static output."""

    host: torch.Tensor
    x: torch.Tensor
    copied: torch.cuda.Event
    graph: Captured | None = None
    y: torch.Tensor | None = None


@dataclasses.dataclass
class BatchedApply:
    """Batched serving entry point: `net_apply` on one wave, one CUDA graph
    per shape bucket.

    The port of the reference's jit cache: ``buckets`` holds one entry per
    (net, weight set, variant key, impl, input shape), the reference's
    cache key, and ``compiles`` counts them, as the reference counts its
    executables.  A call names the batch's shape and a ``fill`` that
    writes the padded batch on the host, and runs it where the weights
    are.  On a CUDA device each entry is a captured graph
    (`kernels.capture`) between a static input and a static output: a call
    has ``fill`` write the bucket's page-locked host buffer, copies it
    asynchronously into the static input and replays.  The first call of
    a bucket warms `net_apply` up and captures it.  Every graph of the
    instance is captured into one memory pool, so a graph's intermediates
    may lie where another bucket's output lies: the output returned is the
    graph's static buffer, valid until the next call of any bucket of this
    instance, so read or clone it before that.  A failed capture or replay
    raises; there is no eager fallback on the card.  On the CPU each call
    runs `net_apply` eagerly and the entry is None.

    With a ``mesh`` (and ``rules``, the serving rules by default) the
    forward runs inside `parallel.sharding.use_mesh` and the key names the
    mesh: a ``sparse`` tree from `shard_sparse` then runs each FC head's
    strips on their own rank and gathers the logits (the reference's
    sharded compile path); a captured graph holds that gather.
    """

    net: SparseNet
    params: dict
    sparse: dict | None = None
    impl: str = "auto"
    key: tuple = ()
    buckets: dict = dataclasses.field(default_factory=dict)
    mesh: Any = None
    rules: Any = None
    pool: Any = dataclasses.field(default=None, init=False)

    def bucket_key(self, shape: tuple) -> tuple:
        return (self.net.name, id(self.params), id(self.sparse), self.key,
                self.impl, id(self.mesh), tuple(shape))

    @property
    def device(self) -> torch.device:
        """Where the weights are, and so where the forward runs."""
        return next(t for entry in self.params.values()
                    for t in entry.values()).device

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return net_apply(self.net, self.params, x, sparse=self.sparse,
                             impl=self.impl)
        with shd.use_mesh(self.mesh, self.rules or shd.SERVE_RULES):
            return net_apply(self.net, self.params, x, sparse=self.sparse,
                             impl=self.impl)

    def __call__(self, shape: tuple, fill: Callable[[np.ndarray], Any]
                 ) -> torch.Tensor:
        """The logits of one f32 batch of ``shape`` (N, H, W, C), which
        ``fill`` writes on the host into the array it is given, computed
        on the weights' device."""
        dev, shape = self.device, tuple(shape)
        with torch.inference_mode():
            key = self.bucket_key(shape)
            if dev.type != "cuda":
                self.buckets.setdefault(key, None)
                x = np.empty(shape, np.float32)
                fill(x)
                return self._forward(torch.from_numpy(x).to(dev))
            b = self.buckets.get(key)
            if b is None:
                b = self.buckets[key] = _Bucket(
                    torch.empty(shape, dtype=torch.float32, pin_memory=True),
                    torch.empty(shape, dtype=torch.float32, device=dev),
                    torch.cuda.Event())
            b.copied.synchronize()   # the last copy out of ``host`` is done
            fill(b.host.numpy())
            b.x.copy_(b.host, non_blocking=True)
            b.copied.record()
            if b.graph is None:
                if self.pool is None:
                    self.pool = torch.cuda.graph_pool_handle()
                b.graph, b.y = capture(lambda: self._forward(b.x),
                                       pool=self.pool)
            b.graph.replay()
            return b.y

    @property
    def compiles(self) -> int:
        """Shape buckets served (all variants); on the card, the captured
        graphs."""
        return sum(b is None or b.graph is not None
                   for b in self.buckets.values())

    @property
    def replays(self) -> int:
        """Graph replays over every bucket (0 on the CPU)."""
        return sum(b.graph.replays for b in self.buckets.values()
                   if b is not None and b.graph is not None)


def _placed(t: torch.Tensor | None, device: torch.device, copy: bool
            ) -> torch.Tensor | None:
    return None if t is None else t.to(device, copy=copy)


def place_params(params: dict, device: str | torch.device, *,
                 copy: bool = True) -> dict:
    """A param tree ({layer: {leaf: tensor}}) on ``device``: a copy of
    every tensor (a replica's own weights, also where the tree already
    lies), or with ``copy=False`` the tensors already there as they are."""
    dev = torch.device(device)
    return {name: {k: _placed(t, dev, copy) for k, t in entry.items()}
            for name, entry in params.items()}


def shard_sparse(sparse: dict, device: str | torch.device, *,
                 model: int = 1, copy: bool = True) -> dict:
    """Place a `sparsify` tree on a replica's devices: a copy of every
    tensor of every entry on ``device`` (with ``copy=False`` the tensors
    already there stay as they are).

    Under a mesh (`parallel.sharding.use_mesh` over a `DeviceMesh`) the
    reference's sharding (``graph.py:849``): each FC head's strips, the
    leading NB dim of ``vals`` (NB, S, vk, vn) and ``idx`` (NB, S), are
    cout-sharded by the ``ff`` rule (the model dim), a DTensor of which
    each rank keeps its own strips; a strip count that does not divide
    stays whole on every rank (`sharding.spec_for`).  Bias and scale stay
    whole.  Convs follow the ``conv`` rule, replicated by default: they
    then stay plain tensors on ``device``.  A ``conv`` rule on a mesh dim
    cout-shards each conv's strips the same way (`_sharded_conv` runs
    them); a conv whose strip count does not divide stays whole, a
    plain tensor.

    Without a mesh ``model`` must be 1 (one device a replica: every
    replica of one card); a wider ``model`` axis needs the mesh's ranks
    and raises `NotImplementedError` rather than replicate the heads.
    """
    dev = torch.device(device)
    ctx = shd.current()
    if ctx is None and model != 1:
        raise NotImplementedError(
            f"shard_fc over {model} devices a replica needs a mesh of "
            f"{model} ranks (launch.mesh; ROADMAP queue 1, \"Waiting for a "
            f"multi-card cell\")")

    def place_vs(vs: VectorSparse, axis: str | None) -> VectorSparse:
        vals, idx = _placed(vs.vals, dev, copy), _placed(vs.idx, dev, copy)
        if axis is not None:
            vals = shd.distribute(vals, (axis, None, None, None))
            idx = shd.distribute(idx, (axis, None))
        return VectorSparse(vals=vals, idx=idx, shape=vs.shape)

    out = {}
    for name, entry in sparse.items():
        if isinstance(entry, SparseConv):
            sharded = ctx is not None and shd.spec_for(
                ("conv", None, None, None), mesh=ctx.mesh, rules=ctx.rules,
                shape=tuple(entry.vs.vals.shape))[0] is not None
            out[name] = dataclasses.replace(
                entry, vs=place_vs(entry.vs, "conv" if sharded else None),
                bias=_placed(entry.bias, dev, copy),
                scale=_placed(entry.scale, dev, copy))
        elif isinstance(entry, SparseFC):
            out[name] = dataclasses.replace(
                entry, vs=place_vs(entry.vs, "ff" if ctx else None),
                bias=_placed(entry.bias, dev, copy),
                scale=_placed(entry.scale, dev, copy))
        else:  # a bare VectorSparse entry (FC-style)
            out[name] = place_vs(entry, "ff" if ctx else None)
    return out


# --------------------------------------------------------------------------
# Generic sparsification (BN folding + vector pruning + remainder strips)
# --------------------------------------------------------------------------

def sparsify(net: SparseNet, params: dict, density: float, *,
             vk: int = 32, vn: int = 128,
             include_fc: bool = True, dtype: Any = None) -> tuple[dict, dict]:
    """Vector-prune a whole network to `density` (fraction of kept vectors).

    Returns ``(sparse, pruned)``: ``sparse`` maps layer names to
    `SparseConv` / `SparseFC` for `net_apply` (BN folded into the weights
    and a bias before pruning; small-Cin stems kept dense with padded
    channels; non-tileable FC heads given a remainder strip), ``pruned`` is
    a dense param tree computing the same function (the oracle).  Pruning
    and index building run host-side in numpy; the encoded tiles land on
    the params' device.

    ``dtype="int8"`` quantizes every encoded weight per cout from the
    pruned, BN-folded weights and stores the dequant scales on the entries;
    ``pruned`` then holds the dequantized f32 weights.  Any dtype other
    than f32 or int8 raises.
    """
    int8 = _encode_int8(dtype)
    sparse: dict = {}
    pruned = {name: dict(entry) for name, entry in params.items()}
    for l in net.layers:
        if isinstance(l, Conv):
            p = params[l.name]
            dev, wdt = p["w"].device, p["w"].dtype
            w = _np(p["w"])
            cin_g = w.shape[2]
            if l.bn:
                g, b = _bn_fold(p)
                w = w * g  # scale per cout (last axis)
            elif "b" in p:
                b = _np(p["b"])
            else:
                b = np.zeros((w.shape[3],), np.float32)
            # grouped layers always prune; ungrouped small-Cin stems stay
            # dense
            prune = True if l.groups > 1 else cin_g >= vk
            spec, wp = sparse_conv_from_dense(
                w, density, vk=vk, vn=vn, stride=l.stride, groups=l.groups,
                dilation=l.dilation, prune=prune,
                dtype="int8" if int8 else None,
                allow_fallback=l.allow_fallback, path=f"{net.name}/{l.name}",
                device=dev)
            spec.bias = torch.as_tensor(b, dtype=wdt, device=dev)
            sparse[l.name] = spec
            pruned[l.name] = {"w": torch.as_tensor(wp, dtype=wdt, device=dev),
                              "b": spec.bias}
        elif isinstance(l, FC) and include_fc:
            p = params[l.name]
            dev, wdt = p["w"].device, p["w"].dtype
            w = _np(p["w"])
            din, dout = w.shape
            fg = fc_tile_geometry(din, dout, vk=vk, vn=vn)
            if fg is None:
                continue  # non-tileable K: stays dense
            wpad = np.pad(w, ((0, 0), (0, fg.pad))) if fg.pad else w
            wp, mask = prune_vectors_balanced(wpad, density, fg.vk, fg.vn)
            s_w, enc = None, torch.as_tensor(wp, dtype=wdt, device=dev)
            if int8:
                s_w = weight_scales(wp)  # pad columns (all-zero) -> 1.0
                wq = quantize_weights_int8(wp, s_w)
                wp = wq.astype(np.float32) * s_w
                enc, s_w = (torch.as_tensor(wq, device=dev),
                            torch.as_tensor(s_w, device=dev))
            sparse[l.name] = SparseFC(from_mask(enc, mask, fg.vk, fg.vn),
                                      dout=dout, bias=p["b"], scale=s_w)
            pruned[l.name] = {"w": torch.as_tensor(wp[:, :dout], dtype=wdt,
                                                   device=dev),
                              "b": p["b"]}
    return sparse, pruned


# --------------------------------------------------------------------------
# Builders
# --------------------------------------------------------------------------

# channels per conv layer; 'M' = 2x2 max-pool
VGG16_LAYERS = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                512, 512, 512, "M", 512, 512, 512, "M"]


def build_vgg16(num_classes: int = 1000, *,
                image_size: int = 224) -> SparseNet:
    """The paper's evaluation model: 13 3x3 convs (ReLU, no BN) with five
    2x2 max-pools, Flatten, fc1/fc2 (ReLU) and the classifier.  fc1's
    fan-in ``512 * (image_size // 32)**2`` ties the net to its image size.
    The first conv (cin 3 padded to 8) runs the conv kernels' stem body in
    f32, the other 12 their generic body, the three FCs vsmm."""
    layers: list = []
    cin, i = 3, 1
    for c in VGG16_LAYERS:
        if c == "M":
            layers.append(Pool("max", 2))
        else:
            layers.append(Conv(f"conv{i}", cin, c))
            cin, i = c, i + 1
    fc_in = 512 * (image_size // 32) ** 2
    layers += [
        Flatten(),
        FC("fc1", fc_in, 4096),
        FC("fc2", 4096, 4096),
        Classifier("fc3", 4096, num_classes),
    ]
    return SparseNet("vgg16", tuple(layers))


# (channels, blocks) per stage — the ResNet-18 basic-block plan.
RESNET18_STAGES = ((64, 2), (128, 2), (256, 2), (512, 2))


def _basic_block(layers: list, prefix: str, cin: int, cout: int,
                 stride: int) -> None:
    """Append one ResNet basic block: conv-BN-ReLU -> conv-BN -> (+id) ReLU,
    the shortcut (the block input or its stride-matched 1x1 BN projection)
    added in conv2's fused epilogue."""
    inkey = f"{prefix}_in"
    layers.append(Save(inkey))
    idkey = inkey
    if stride != 1 or cin != cout:
        idkey = f"{prefix}_id"
        layers.append(Conv(f"{prefix}_down", cin, cout, 1, 1, stride,
                           bn=True, relu=False, src=inkey, dst=idkey))
    layers.append(Conv(f"{prefix}_conv1", cin, cout, 3, 3, stride, bn=True))
    layers.append(Conv(f"{prefix}_conv2", cout, cout, 3, 3, 1, bn=True,
                       residual=idkey))


def build_resnet18(num_classes: int = 1000, *,
                   image_size: int = 224) -> SparseNet:
    """ResNet-18: 7x7/s2 BN stem, 3x3/s2 max-pool, 4 stages x 2 basic
    blocks (stride-2 1x1 BN-projection downsamples), GAP, 512-d classifier.
    17 convs run the halo kernel, 3 projections and the head run vsmm."""
    del image_size  # geometry is size-agnostic; kept for config symmetry
    layers: list = [
        Conv("conv1", 3, 64, 7, 7, 2, bn=True),
        Pool("max", 3, stride=2, padding="SAME"),
    ]
    cin = 64
    for si, (c, blocks) in enumerate(RESNET18_STAGES):
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            _basic_block(layers, f"layer{si + 1}_{bi}", cin, c, stride)
            cin = c
    layers += [Pool("gap"), Flatten(), Classifier("fc", 512, num_classes)]
    return SparseNet("resnet18", tuple(layers))


# (channels, blocks) per stage — the ResNet-34 basic-block plan: the
# ResNet-50 stage depths on ResNet-18's block type.
RESNET34_STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))


def build_resnet34(num_classes: int = 1000, *,
                   image_size: int = 224) -> SparseNet:
    """ResNet-34: ResNet-18's basic blocks at the (3, 4, 6, 3) stage
    depths; no new conv geometry (7x7/s2 stem, 3x3 bodies, 1x1/s2
    BN-projection downsamples).  33 convs run the halo kernel (the stem on
    its stem body), 3 projections and the head run vsmm."""
    del image_size  # geometry is size-agnostic; kept for config symmetry
    layers: list = [
        Conv("conv1", 3, 64, 7, 7, 2, bn=True),
        Pool("max", 3, stride=2, padding="SAME"),
    ]
    cin = 64
    for si, (c, blocks) in enumerate(RESNET34_STAGES):
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            _basic_block(layers, f"layer{si + 1}_{bi}", cin, c, stride)
            cin = c
    layers += [Pool("gap"), Flatten(), Classifier("fc", 512, num_classes)]
    return SparseNet("resnet34", tuple(layers))


# (bottleneck width, blocks) per stage — ResNet-50's plan; output channels
# are 4x the bottleneck width (the expansion).
RESNET50_STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))


def _bottleneck_block(layers: list, prefix: str, cin: int, c: int,
                      stride: int) -> None:
    """Append one ResNet bottleneck: 1x1 reduce -> 3x3 (stride) -> 1x1
    expand (4x), BN throughout, the shortcut (the block input or a
    1x1/stride BN projection of it when the shape changes) added in the
    expand conv's fused epilogue before the final ReLU."""
    cout = 4 * c
    inkey = f"{prefix}_in"
    layers.append(Save(inkey))
    idkey = inkey
    if stride != 1 or cin != cout:
        idkey = f"{prefix}_id"
        layers.append(Conv(f"{prefix}_down", cin, cout, 1, 1, stride,
                           bn=True, relu=False, src=inkey, dst=idkey))
    layers.append(Conv(f"{prefix}_conv1", cin, c, 1, 1, 1, bn=True))
    layers.append(Conv(f"{prefix}_conv2", c, c, 3, 3, stride, bn=True))
    layers.append(Conv(f"{prefix}_conv3", c, cout, 1, 1, 1, bn=True,
                       residual=idkey))


def build_resnet50(num_classes: int = 1000, *,
                   image_size: int = 224) -> SparseNet:
    """ResNet-50: ResNet-18's 7x7/s2 BN stem and max-pool, then 4 stages of
    (3, 4, 6, 3) bottleneck blocks (1x1 -> 3x3 -> 1x1 with 4x expansion;
    1x1 BN-projection downsamples, stride 1 in the first block, 2 after),
    GAP, 2048-d classifier.  17 convs run the halo kernel (the stem and 16
    3x3s); the 32 block 1x1s (each conv3 with the shortcut fused), the 4
    projections and the head run vsmm."""
    del image_size  # geometry is size-agnostic; kept for config symmetry
    layers: list = [
        Conv("conv1", 3, 64, 7, 7, 2, bn=True),
        Pool("max", 3, stride=2, padding="SAME"),
    ]
    cin = 64
    for si, (c, blocks) in enumerate(RESNET50_STAGES):
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            _bottleneck_block(layers, f"layer{si + 1}_{bi}", cin, c, stride)
            cin = 4 * c
    layers += [Pool("gap"), Flatten(), Classifier("fc", 2048, num_classes)]
    return SparseNet("resnet50", tuple(layers))


# (pointwise output channels, depthwise stride) per separable block — the
# standard MobileNetV1 plan after the 3x3/s2/32 stem.
MOBILENET_V1_PLAN = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                     (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                     (512, 1), (1024, 2), (1024, 1))


def build_mobilenet_v1(num_classes: int = 1000, *,
                       image_size: int = 224) -> SparseNet:
    """MobileNetV1: 3x3/s2 BN stem, then 13 depthwise-separable blocks
    (3x3 depthwise BN-ReLU -> 1x1 pointwise BN-ReLU), GAP, 1024-d
    classifier.  The stem runs the full conv kernel (cin padded 3 -> 8),
    the 13 depthwise convs (``Conv(groups=cin)``) the per-channel tap
    kernel, the 13 pointwise convs and the head vsmm."""
    del image_size  # geometry is size-agnostic; kept for config symmetry
    layers: list = [Conv("conv0", 3, 32, 3, 3, 2, bn=True)]
    cin = 32
    for i, (c, s) in enumerate(MOBILENET_V1_PLAN, 1):
        layers.append(Conv(f"dw{i}", cin, cin, 3, 3, s, bn=True,
                           groups=cin))
        layers.append(Conv(f"pw{i}", cin, c, 1, 1, 1, bn=True))
        cin = c
    layers += [Pool("gap"), Flatten(), Classifier("fc", 1024, num_classes)]
    return SparseNet("mobilenet_v1", tuple(layers))


def build_resnet_stem() -> SparseNet:
    """The minimal geometry-coverage network (7x7/s2 -> 1x1 -> 3x3/s2; no
    BN, plain biases)."""
    return SparseNet("resnet_stem", (
        Conv("stem7x7", 3, 64, 7, 7, 2),
        Conv("proj1x1", 64, 128, 1, 1, 1),
        Conv("down3x3", 128, 128, 3, 3, 2),
    ))
