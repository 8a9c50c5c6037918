"""vscheck pass 1 — IR validation: shape/geometry inference over
`models.graph.SparseNet` layer graphs.

The port of `repro/analysis/ir.py`.  `check_net` walks a net's layer specs
propagating the NHWC stream shape (and every saved slot) through
Conv/FC/Pool/ResidualAdd/Save/Flatten and checks each layer's geometry
before anything runs: channel-count agreement, grouped divisibility,
residual-arm shape match at the fused add, slot liveness, pools that
collapse the map, and the tile-geometry rules `sparsify` applies
(`graph.conv_tile_geometry` / `fc_tile_geometry`: the same code, so the
analyzer cannot drift from the encoder).

The walk also emits one `ConvSite` / `FCSite` per sparse-encodable layer.
Rule ids are the VSC1xx block of `analysis.diagnostics.RULES`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.graph import (
    FC, Conv, ConvTileGeometry, FCTileGeometry, Flatten, Pool, ResidualAdd,
    Save, SparseNet, TileGeometryError, conv_tile_geometry, fc_tile_geometry,
    strip_steps,
)

from .diagnostics import Report

__all__ = ["ConvSite", "FCSite", "NetCheck", "check_net"]


@dataclasses.dataclass(frozen=True)
class ConvSite:
    """Static description of one conv layer's sparse-kernel invocation."""

    name: str
    path: str                            # net/layer
    x_shape: tuple[int, int, int, int]   # encoded NHWC input (cin_pad incl.)
    kh: int
    kw: int
    stride: int
    groups: int
    dilation: int
    cout: int                            # encoded output width
    geom: ConvTileGeometry
    s_steps: int
    has_residual: bool


@dataclasses.dataclass(frozen=True)
class FCSite:
    """Static description of one FC layer's sparse-matmul invocation.
    ``geom`` is None when the layer stays dense (VSC116)."""

    name: str
    path: str
    m: int                               # batch rows
    din: int
    dout: int
    geom: FCTileGeometry | None
    s_steps: int


@dataclasses.dataclass
class NetCheck:
    """Result of one IR walk: diagnostics + the per-layer kernel sites."""

    report: Report
    conv_sites: list[ConvSite]
    fc_sites: list[FCSite]
    out_shape: tuple[int, ...] | None


def _pool_out(size_in: int, size: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size_in // stride)
    return (size_in - size) // stride + 1


def _conv_out(size_in: int, k: int, stride: int, dilation: int) -> int:
    # XLA "SAME" for the given stride: out = ceil(in / stride)
    del k, dilation
    return -(-size_in // stride)


def check_net(
    net: SparseNet,
    input_shape: tuple[int, int, int, int],
    *,
    density: float = 0.25,
    vk: int = 32,
    vn: int = 128,
) -> NetCheck:
    """Shape/geometry inference over ``net`` for a (N, H, W, C) input.

    Returns a `NetCheck`; errors in its report mean the net cannot run (or
    would compute garbage) at this input shape; `launch.serve.CNNServer`
    refuses placement on them.  Warnings flag wasteful-but-valid shapes.
    """
    rep = Report()
    sites: list[ConvSite] = []
    fcs: list[FCSite] = []
    shape: tuple[int, ...] | None = tuple(int(d) for d in input_shape)
    if len(shape) != 4 or any(d < 1 for d in shape):
        rep.error("VSC103", net.name,
                  f"input shape {shape} is not a positive NHWC shape")
        return NetCheck(rep, sites, fcs, None)
    saved: dict[str, tuple[int, ...]] = {}

    def read_slot(key: str, path: str, what: str) -> tuple[int, ...] | None:
        if key not in saved:
            rep.error("VSC104", path,
                      f"{what} reads slot {key!r} before any layer saved it",
                      hint="add Save / Conv(dst=...) producing the slot "
                           "earlier in the layer tuple")
            return None
        return saved[key]

    for l in net.layers:
        if shape is None:
            break  # a structural error already made downstream shapes moot
        if isinstance(l, Save):
            saved[l.key] = shape
        elif isinstance(l, Conv):
            path = f"{net.name}/{l.name}"
            if min(l.kh, l.kw, l.stride, l.dilation, l.groups, l.cin,
                   l.cout) < 1:
                rep.error("VSC103", path,
                          f"non-positive geometry parameter in {l}")
                shape = None
                break
            xin = read_slot(l.src, path, "Conv.src") if l.src else shape
            if xin is None:
                shape = None
                break
            if len(xin) != 4:
                rep.error("VSC107", path,
                          f"Conv on a rank-{len(xin)} stream {xin} "
                          f"(after Flatten?)")
                shape = None
                break
            n, h, w, c = xin
            if c != l.cin:
                rep.error("VSC101", path,
                          f"stream carries C={c} but Conv.cin={l.cin}")
                shape = None
                break
            if l.cin % l.groups or l.cout % l.groups:
                rep.error("VSC102", path,
                          f"cin={l.cin} / cout={l.cout} not divisible by "
                          f"groups={l.groups}")
                shape = None
                break
            if (l.kh - 1) * l.dilation + 1 > h or \
                    (l.kw - 1) * l.dilation + 1 > w:
                rep.warn("VSC112", path,
                         f"effective kernel extent "
                         f"({(l.kh - 1) * l.dilation + 1}x"
                         f"{(l.kw - 1) * l.dilation + 1}) exceeds the "
                         f"{h}x{w} input: some taps read padding only")
            cin_g = l.cin // l.groups
            try:
                geom = conv_tile_geometry(
                    l.kh, l.kw, cin_g, l.cout, vk=vk, vn=vn, groups=l.groups,
                    allow_fallback=l.allow_fallback, path=path)
            except TileGeometryError as e:
                rep.error(e.rule, e.path, e.message, e.hint)
                shape = None
                break
            if l.groups > 1 and cin_g == 1 and not geom.depthwise:
                # allow_fallback=True accepted the vk==1 grouped fallback;
                # still worth flagging
                rep.warn("VSC109", path,
                         f"channel-multiplier depthwise falls back to "
                         f"grouped kernels with vk={geom.vk} (MXU-wasteful)")
            if geom.cin_pad >= geom.vk:
                rep.error("VSC111", path,
                          f"cin padding {geom.cin_pad} >= K-tile {geom.vk}: "
                          f"a whole all-zero tile per tap")
            if geom.vn < 8 and geom.vn < min(vn, l.cout):
                rep.warn("VSC110", path,
                         f"output strip shrunk to vn={geom.vn} (cout="
                         f"{l.cout} has no divisor near {vn}): lane "
                         f"utilization {geom.vn}/{vn}",
                         hint="pick a cout with a larger power-of-two "
                              "divisor")
            ho = _conv_out(h, l.kh, l.stride, l.dilation)
            wo = _conv_out(w, l.kw, l.stride, l.dilation)
            if ho < 1 or wo < 1:
                rep.error("VSC108", path,
                          f"conv output {ho}x{wo} collapses the feature map")
                shape = None
                break
            out = (n, ho, wo, l.cout)
            if l.residual:
                rshape = read_slot(l.residual, path, "Conv.residual")
                if rshape is not None and rshape != out:
                    rep.error(
                        "VSC105", path,
                        f"residual arm {l.residual!r} is {rshape}, the conv "
                        f"produces {out}: the fused add cannot broadcast",
                        hint="insert a projection conv on the shortcut "
                             "(stride/channel match)")
            # the prune rule sparsify applies: grouped layers always prune
            # (per-strip == per-group quota); ungrouped small-cin stems
            # stay dense-in-format
            prune = True if l.groups > 1 else cin_g >= vk
            s_steps = strip_steps(geom.kb, density, prune=prune)
            c_enc = l.cin + (0 if geom.depthwise or l.groups > 1
                             else geom.cin_pad)
            sites.append(ConvSite(
                name=l.name, path=path, x_shape=(n, h, w, c_enc), kh=l.kh,
                kw=l.kw, stride=l.stride, groups=l.groups,
                dilation=l.dilation, cout=l.cout, geom=geom, s_steps=s_steps,
                has_residual=l.residual is not None,
            ))
            if l.dst:
                saved[l.dst] = out
            else:
                shape = out
        elif isinstance(l, ResidualAdd):
            path = f"{net.name}/residual_add[{l.key}]"
            rshape = read_slot(l.key, path, "ResidualAdd")
            if rshape is not None and rshape != shape:
                rep.error("VSC105", path,
                          f"shortcut {l.key!r} is {rshape}, the stream is "
                          f"{shape}")
        elif isinstance(l, Pool):
            path = f"{net.name}/pool[{l.kind}]"
            if len(shape) != 4:
                rep.error("VSC107", path,
                          f"Pool on a rank-{len(shape)} stream {shape}")
                shape = None
                break
            n, h, w, c = shape
            if l.kind == "gap":
                shape = (n, 1, 1, c)
            else:
                stride = l.stride or l.size
                ho = _pool_out(h, l.size, stride, l.padding)
                wo = _pool_out(w, l.size, stride, l.padding)
                if ho < 1 or wo < 1:
                    rep.error("VSC108", path,
                              f"{l.size}x{l.size}/s{stride} {l.padding} "
                              f"pool of a {h}x{w} map yields {ho}x{wo}")
                    shape = None
                    break
                shape = (n, ho, wo, c)
        elif isinstance(l, Flatten):
            if len(shape) != 4:
                rep.error("VSC107", f"{net.name}/flatten",
                          f"Flatten on a rank-{len(shape)} stream {shape}")
                shape = None
                break
            n, h, w, c = shape
            shape = (n, h * w * c)
        elif isinstance(l, FC):
            path = f"{net.name}/{l.name}"
            if min(l.din, l.dout) < 1:
                rep.error("VSC103", path, f"non-positive FC dims in {l}")
                shape = None
                break
            if len(shape) != 2:
                rep.error("VSC107", path,
                          f"FC on a rank-{len(shape)} stream {shape}",
                          hint="insert Flatten() before the FC head")
                shape = None
                break
            n, feats = shape
            if feats != l.din:
                rep.error("VSC106", path,
                          f"flattened features {feats} != FC.din {l.din}")
                shape = None
                break
            fgeom = fc_tile_geometry(l.din, l.dout, vk=vk, vn=vn)
            if fgeom is None:
                rep.warn("VSC116", path,
                         f"din={l.din} is not a multiple of vk={vk}: the "
                         f"layer stays dense at sparsify time")
                s_steps = 0
            else:
                s_steps = strip_steps(fgeom.kb, density, prune=True)
            fcs.append(FCSite(name=l.name, path=path, m=n, din=l.din,
                              dout=l.dout, geom=fgeom, s_steps=s_steps))
            shape = (n, l.dout)
        else:
            rep.error("VSC103", net.name, f"unknown layer spec {l!r}")
            shape = None
            break
    return NetCheck(rep, sites, fcs, shape)
