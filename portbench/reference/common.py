"""What the plain references share: layer shapes, the parameter schema,
weight preparation and the plain ops.

The served weights follow one public recipe (VSCNN, arXiv:2205.02271):
inference BN is folded into the conv weights and a bias, then every conv
whose input has at least ``vk`` channels and every FC is vector-pruned by
the balanced rule (`portbench._frozen.pruning`), each output strip keeping
its ``round(KB * density)`` tiles of largest norm.  `prepare` does that
here again from the dense weights, in numpy on the host, and gives
weights in PyTorch's own layouts (OIHW convs, (din, dout) FCs).

The ops run NCHW with F.conv2d, F.max_pool2d and plain matmuls: another
layout and other library code than the program's.  "SAME" padding is
TensorFlow's: ``total = max((ceil(H/s) - 1) * s + k - H, 0)``, the odd
element on the high side.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from portbench._frozen.pruning import (Geometry, conv_geometry, fc_geometry,
                                       prune_balanced, strip_steps)

__all__ = ["Layer", "BN_EPS", "schema", "geometry", "kept_weights",
           "prepare", "conv", "max_pool_same", "precision"]

BN_EPS = 1e-5   # inference BN's epsilon (the frameworks' default)


@dataclasses.dataclass(frozen=True)
class Layer:
    """One conv or FC layer with the shapes of one image through it."""

    name: str
    op: str                 # "conv" | "fc"
    cin: int
    cout: int
    kh: int = 1
    kw: int = 1
    stride: int = 1
    bn: bool = False
    relu: bool = True
    residual: bool = False  # the shortcut is added before the ReLU
    h_in: int = 1
    w_in: int = 1
    h_out: int = 1
    w_out: int = 1


def out_size(size: int, stride: int) -> int:
    return -(-size // stride)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    total = max((out_size(size, stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def schema(layers: list[Layer]) -> dict:
    """{layer: {leaf: shape}}: HWIO conv weights with BN (scale, offset,
    mean, var) or a bias, (din, dout) FC weights and a bias."""
    out = {}
    for l in layers:
        if l.op == "conv":
            e = {"w": (l.kh, l.kw, l.cin, l.cout)}
            if l.bn:
                e.update(scale=(l.cout,), offset=(l.cout,), mean=(l.cout,),
                         var=(l.cout,))
            else:
                e["b"] = (l.cout,)
        else:
            e = {"w": (l.cin, l.cout), "b": (l.cout,)}
        out[l.name] = e
    return out


def geometry(l: Layer, *, vk: int, vn: int) -> Geometry | None:
    if l.op == "conv":
        return conv_geometry(l.kh, l.kw, l.cin, l.cout, vk=vk, vn=vn)
    return fc_geometry(l.cin, l.cout, vk=vk, vn=vn)


def kept_weights(l: Layer, density: float, *, vk: int, vn: int
                 ) -> tuple[int, int]:
    """(weights kept, kept tiles): what balanced pruning leaves of the
    layer's real weights (no pad rows or columns), and the index entries
    (one a kept tile) that locate them."""
    g = geometry(l, vk=vk, vn=vn)
    dense = l.kh * l.kw * l.cin * l.cout
    if g is None:
        return dense, 0
    s = strip_steps(g.kb, density, prune=g.prune)
    if g.kb == s:
        return dense, g.nb * s
    # pruned layers of these nets have no pad rows; pad columns (an FC's
    # remainder strip) hold no real weight
    return s * g.vk * l.cout, g.nb * s


def prepare(layers: list[Layer], params: dict, density: float, *,
            vk: int, vn: int, device: Any) -> dict:
    """{layer: (weight, bias)} on ``device``: BN folded, pruned by the
    balanced rule, convs OIHW, FCs (din, dout), in f32."""
    out = {}
    for l in layers:
        p = {k: v.detach().float().cpu().numpy() for k, v in
             params[l.name].items()}
        w = p["w"]
        if l.bn:
            g = p["scale"] / np.sqrt(p["var"] + np.float32(BN_EPS))
            w = w * g
            b = p["offset"] - p["mean"] * g
        else:
            b = p["b"]
        geo = geometry(l, vk=vk, vn=vn)
        if geo is not None and geo.prune and density < 1.0:
            if l.op == "conv":
                wm = np.pad(w, ((0, 0), (0, 0), (0, geo.cin_pad), (0, 0)))
                wm = wm.reshape(-1, l.cout)
                wm, _ = prune_balanced(wm, density, geo.vk, geo.vn)
                w = wm.reshape(l.kh, l.kw, l.cin + geo.cin_pad,
                               l.cout)[:, :, :l.cin]
            else:
                wm = np.pad(w, ((0, 0), (0, geo.pad)))
                wm, _ = prune_balanced(wm, density, geo.vk, geo.vn)
                w = wm[:, :l.cout]
        wt = torch.from_numpy(np.ascontiguousarray(w, np.float32))
        if l.op == "conv":
            wt = wt.permute(3, 2, 0, 1).contiguous()   # HWIO -> OIHW
        out[l.name] = (wt.to(device),
                       torch.from_numpy(np.asarray(b, np.float32)).to(device))
    return out


def conv(x: torch.Tensor, wb: tuple, l: Layer, *,
         residual: torch.Tensor | None = None) -> torch.Tensor:
    """NCHW SAME conv + bias (+ residual) (+ ReLU)."""
    w, b = wb
    pt, pb = same_pads(x.shape[2], l.kh, l.stride)
    pl, pr = same_pads(x.shape[3], l.kw, l.stride)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb))
    y = F.conv2d(x, w, b, stride=l.stride)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if l.relu else y


def fc(x: torch.Tensor, wb: tuple, l: Layer) -> torch.Tensor:
    w, b = wb
    y = x @ w + b
    return torch.relu(y) if l.relu else y


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """NCHW max pool with SAME padding (pads are -inf)."""
    pt, pb = same_pads(x.shape[2], k, stride)
    pl, pr = same_pads(x.shape[3], k, stride)
    x = F.pad(x, (pl, pr, pt, pb), value=-math.inf)
    return F.max_pool2d(x, k, stride)


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """Matmuls and cuDNN convolutions in f32 (``tf32=False``) or in TF32,
    the settings restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
