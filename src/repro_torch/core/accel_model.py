"""Cycle model of the VSCNN PE array (paper §II-III, Table I), the port's
copy of `repro/core/accel_model.py`.

Geometry (Fig. 4/5): a PE config ``[B, R, C]`` has B PE-array blocks, each
R rows x C(=3) columns.  Every cycle one block consumes:

  * one input-activation column vector  (R consecutive H positions, one W
    column, one input channel)   — broadcast horizontally, and
  * one weight kernel column            (C=3 ky-elements for one kx, one
    (cin, cout) pair)            — broadcast vertically;

the outer product accumulates diagonally into R (+C-1 boundary) output
partial sums.  Dense cost for an H x W x Cin input and 3x3xCinxCout kernel:

    cycles_dense = ceil(H/R) * W * 3 * Cin * ceil(Cout/B)        (block_map='cout')

(check: 5x5 input, pad 1, R=5, B=1, Cin=Cout=1  ->  1*5*3 = 15 cycles,
exactly the paper's "15 cycles for 5x5 input"; the Table-I sparse example
issues only {A,C,D,E} x {WA,WB} = 8 cycles.)

Sparse rule: a cycle is skipped iff its input vector is all-zero OR every
weight column it would feed in the lockstep block group is all-zero — the
vectors are simply absent from SRAM (paper Fig. 7 dashed blocks).

The model generalizes beyond the paper's 3x3/s1 evaluation to arbitrary
kh x kw kernels, strides, groups and dilation (`conv_layer_cycles`).

Alongside the cycle counts, `conv_layer_traffic` / `network_traffic_reports`
model the DRAM side of the paper's story: the bytes per conv layer of the
reference's two TPU input layouts (the halo-blocked direct input and the
materialized row-tap stack), with the formulas of the cost model the port
keeps beside its kernels (`kernels.vsconv.halo_kernel_cost` and the
others).  They describe that layout and cost contract, not the CUDA
kernels' own traffic.

The time model's free constants are fitted to measured per-layer times on
the backend that runs the port (`core.calibration`, ``calibrate_torch.py``):
`load_calibration` returns them and `predicted_layer_time_s` turns a
layer's modeled features into a calibrated time.

Inputs may be numpy arrays or torch tensors (on any device): everything
here computes in numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any

import numpy as np

if TYPE_CHECKING:
    from .calibration import CalibConstants

__all__ = ["PEConfig", "PE_4_14_3", "PE_8_7_3", "CycleReport",
           "TrafficReport", "conv_layer_cycles", "conv_layer_traffic",
           "aggregate", "network_cycle_reports", "network_traffic_reports",
           "load_calibration", "predicted_layer_time_s", "table1_example"]


def to_numpy(a: Any) -> np.ndarray:
    """A numpy view of ``a``: a torch tensor (any device) is copied to the
    host; anything else goes through `np.asarray`."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True)
class PEConfig:
    blocks: int
    rows: int
    cols: int = 3
    block_map: str = "cout"  # what the B blocks parallelize over: 'cout'|'width'

    @property
    def n_pe(self) -> int:
        return self.blocks * self.rows * self.cols


# The paper's two 168-PE configurations (§IV).
PE_4_14_3 = PEConfig(blocks=4, rows=14, cols=3)
PE_8_7_3 = PEConfig(blocks=8, rows=7, cols=3)


@dataclasses.dataclass
class CycleReport:
    dense: int
    vscnn: int
    ideal_vector: int
    ideal_fine: int
    macs_nonzero: int
    macs_dense: int

    @property
    def speedup(self) -> float:
        return self.dense / max(self.vscnn, 1)

    @property
    def frac_ideal_vector_exploited(self) -> float:
        """Paper §IV: share of ideal-vector-sparse skippable cycles we skip."""
        skippable = self.dense - self.ideal_vector
        return (self.dense - self.vscnn) / max(skippable, 1)

    @property
    def frac_ideal_fine_exploited(self) -> float:
        skippable = self.dense - self.ideal_fine
        return (self.dense - self.vscnn) / max(skippable, 1)


def _input_vector_occupancy(x_nz: np.ndarray, rows: int) -> np.ndarray:
    """(H, W, Cin) nonzero map -> (ceil(H/R), W, Cin) vector occupancy."""
    h, w, cin = x_nz.shape
    hc = math.ceil(h / rows)
    pad = hc * rows - h
    if pad:
        x_nz = np.concatenate([x_nz, np.zeros((pad, w, cin), bool)], axis=0)
    return x_nz.reshape(hc, rows, w, cin).any(axis=1)


def _same_geometry(size: int, k: int, stride: int,
                   dilation: int = 1) -> tuple[int, int]:
    """XLA-"SAME": (out_size, pad_low)."""
    from .sparse_ops import same_pads

    out, lo, _ = same_pads(size, k, stride, dilation)
    return out, lo


def conv_layer_cycles(
    x: Any, w: Any, pe: PEConfig, *, stride: int = 1,
    groups: int = 1, dilation: int = 1,
) -> CycleReport:
    """Cycle counts for one kh x kw / stride / dilation / SAME conv layer,
    optionally grouped.

    x : (H, W, Cin) input activations (already post-ReLU: zeros are real)
    w : (kh, kw, Cin/groups, Cout) possibly vector-pruned weights (grouped
        HWIO layout: output block g reads input channel group g)

    An input column vector broadcast into the array pairs with weight
    kernel column ``kx`` only when some output column reads it — when its
    column index is congruent to ``kx*dilation - pad_left`` mod ``stride``
    (for stride 1, every column pairs with every kx, the paper's Table-I
    accounting).  Boundary partial sums are issued and discarded, as in
    the paper.

    Grouped convs reduce to the ungrouped accounting: rearranging the
    block-diagonal grouped weight into a virtual (kh, kw, Cin, Cout/groups)
    layout — row c holding input channel c's own group's columns — makes
    the single pass below compute the exact per-group totals.  Depthwise
    (groups == Cin) is one pass, not Cin slices.
    """
    x = to_numpy(x)
    w = to_numpy(w)
    if groups > 1:
        cin_g = x.shape[-1] // groups
        cout_g = w.shape[-1] // groups
        assert w.shape[2] == cin_g, (w.shape, x.shape, groups)
        kh_, kw_ = w.shape[:2]
        # (kh, kw, cin_g, G*cout_g) -> (kh, kw, G*cin_g, cout_g): input
        # channel c = g*cin_g + i picks up exactly group g's couts
        w = w.reshape(kh_, kw_, cin_g, groups, cout_g) \
             .transpose(0, 1, 3, 2, 4) \
             .reshape(kh_, kw_, groups * cin_g, cout_g)
        return conv_layer_cycles(x, w, pe, stride=stride, dilation=dilation)
    x_nz = x != 0
    w_nz = w != 0
    h, width, cin = x_nz.shape
    kh, kw, wcin, cout = w_nz.shape
    assert wcin == cin, (w_nz.shape, cin)

    iv = _input_vector_occupancy(x_nz, pe.rows)  # (HC, W, Cin)
    wv = w_nz.any(axis=0)  # weight column occupancy: (kw, Cin, Cout)

    hc = iv.shape[0]
    _, pad_l = _same_geometry(width, kw, stride, dilation)
    # input columns compatible with weight column kx (see docstring)
    col_sets = [
        np.nonzero((np.arange(width) - (kx * dilation - pad_l)) % stride == 0)[0]
        for kx in range(kw)
    ]

    if pe.block_map == "cout":
        g = math.ceil(cout / pe.blocks)
        pad = g * pe.blocks - cout
        wvp = np.concatenate([wv, np.zeros((kw, cin, pad), bool)], -1) if pad else wv
        gwv = wvp.reshape(kw, cin, g, pe.blocks).any(-1)  # (kx, Cin, G)
        vscnn = dense = 0
        for kx in range(kw):
            iv_cnt = iv[:, col_sets[kx]].sum(axis=(0, 1))  # (Cin,) issued
            vscnn += int((iv_cnt * gwv[kx].sum(axis=-1)).sum())
            dense += hc * len(col_sets[kx]) * cin * g
    elif pe.block_map == "width":
        vscnn = dense = 0
        for kx in range(kw):
            cols = col_sets[kx]
            wg = math.ceil(len(cols) / pe.blocks)
            pad = wg * pe.blocks - len(cols)
            ivk = iv[:, cols]
            if pad:
                ivk = np.concatenate(
                    [ivk, np.zeros((hc, pad, cin), bool)], 1
                )
            giv = ivk.reshape(hc, wg, pe.blocks, cin).any(2)  # (HC, WG, Cin)
            vscnn += int((giv.sum(axis=(0, 1)) * wv[kx].sum(axis=-1)).sum())
            dense += hc * wg * cin * cout
    else:
        raise ValueError(pe.block_map)

    # Ideal vector-sparse: every truly-nonzero (input vec, weight col) pair
    # costs 1/B cycles (perfect packing over blocks, no lockstep loss).
    pairs = sum(
        int((iv[:, col_sets[kx]].sum(axis=(0, 1)) * wv[kx].sum(axis=-1)).sum())
        for kx in range(kw)
    )
    ideal_vector = math.ceil(pairs / pe.blocks)

    # Ideal fine-grained: nonzero MACs / total PEs.
    ho, pad_t = _same_geometry(h, kh, stride, dilation)
    wo = math.ceil(width / stride)
    ke_h = (kh - 1) * dilation + 1
    ke_w = (kw - 1) * dilation + 1
    pb = max(stride * (ho - 1) + ke_h - h - pad_t, 0)
    pr = max(stride * (wo - 1) + ke_w - width - pad_l, 0)
    xp = np.pad(x_nz, ((pad_t, pb), (pad_l, pr), (0, 0)))
    # hits[ky,kx,cin] = # output positions whose input tap is nonzero
    hits = np.stack(
        [
            [
                xp[
                    ky * dilation : ky * dilation + stride * (ho - 1) + 1 : stride,
                    kx * dilation : kx * dilation + stride * (wo - 1) + 1 : stride,
                ].sum(axis=(0, 1))
                for kx in range(kw)
            ]
            for ky in range(kh)
        ]
    )  # (kh,kw,Cin)
    w_cnt = w_nz.sum(axis=3)  # (kh,kw,Cin) nonzero couts per tap
    macs_nonzero = int((hits * w_cnt).sum())
    macs_dense = ho * wo * kh * kw * cin * cout
    ideal_fine = math.ceil(macs_nonzero / pe.n_pe)

    return CycleReport(
        dense=dense,
        vscnn=vscnn,
        ideal_vector=ideal_vector,
        ideal_fine=ideal_fine,
        macs_nonzero=macs_nonzero,
        macs_dense=macs_dense,
    )


# --------------------------------------------------------------------------
# DRAM traffic model (bytes in/out per conv layer, stack vs halo)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrafficReport:
    """Modeled DRAM traffic of one conv layer in the reference's layout
    and cost contract.

    ``kernel`` bytes are what the kernel moves under that contract (inputs
    re-fetched per grid schedule + weights + output: the ``bytes_accessed``
    of `kernels.vsconv.halo_kernel_cost` and its siblings); ``build``
    bytes are the layout pass that runs before the kernel (one pad for the
    halo impl; the kh*stride-plane row-tap stack write for the stack
    impl): bytes touched = read source + write laid-out buffer.
    """

    impl: str
    flops: int
    input_bytes: int    # kernel-side activation fetches
    weight_bytes: int
    output_bytes: int
    build_bytes: int    # layout pass (pad / stack materialization)

    @property
    def kernel_bytes(self) -> int:
        return self.input_bytes + self.weight_bytes + self.output_bytes

    @property
    def bytes_accessed(self) -> int:
        return self.kernel_bytes + self.build_bytes

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per DRAM byte — the roofline x-coordinate."""
        return self.flops / max(self.bytes_accessed, 1)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def conv_layer_traffic(
    x_shape: tuple[int, int, int, int],
    *,
    kh: int,
    kw: int,
    stride: int = 1,
    groups: int = 1,
    dilation: int = 1,
    cout: int,
    s_steps: int,
    vk: int,
    vn: int,
    bh: int = 8,
    impl: str = "halo",
    itemsize: int = 4,
    w_itemsize: int | None = None,
    out_itemsize: int | None = None,
    residual: bool = False,
) -> TrafficReport:
    """Modeled DRAM bytes for one vector-sparse conv layer.

    ``x_shape`` is the *encoded* input (N, H, W, Cin) — Cin a vk multiple,
    pad channels included; ``cout`` the encoded output width (a vn
    multiple); ``s_steps`` the stored tiles per strip.  ``impl``: 'halo'
    (direct input, halo-blocked; assumes the cin-major tile order
    `models.graph.sparse_conv_from_dense` emits) or 'stack' (the
    materialized row-tap/phase stack).  Ungrouped 1x1 convs route through
    the sparse matmul over pixels in both impls and cost the same.  A
    grouped conv's strips only fetch their own group's Cin/groups channels;
    depthwise (groups == Cin, vk == 1, vn == the channel-tile width) uses
    the per-channel tap kernels' costs.

    The kernel-side formulas are the port's copies of the reference's
    cost model (`kernels.vsconv.halo_kernel_cost`, `stack_kernel_cost`,
    `kernels.vsconv_dw.dw_halo_kernel_cost`, `dw_stack_kernel_cost`), and
    the model's bytes must equal theirs (asserted below).

    The dtype axis: ``itemsize`` is the activation width, ``w_itemsize``
    the stored-weight width (defaults to ``itemsize``; 1 on the int8
    path), ``out_itemsize`` the output width (the int8 kernels emit f32,
    so 4).  The residual is modeled at ``out_itemsize``.
    """
    from repro_torch.kernels.vsconv import (halo_kernel_cost,
                                            stack_kernel_cost,
                                            use_resident_halo)
    from repro_torch.kernels.vsconv_dw import (dw_halo_kernel_cost,
                                               dw_stack_kernel_cost)

    from .sparse_ops import same_pads

    n, h, w, c = x_shape
    assert c % vk == 0 and cout % vn == 0, (x_shape, cout, vk, vn)
    nb = cout // vn
    cb = c // vk
    # multiplier-1 depthwise only; channel-multiplier convs model through
    # the general grouped branch with vk == 1 (mirrors `ops.vsconv`)
    depthwise = groups > 1 and groups == c and vk == 1 and cout == c
    assert c % groups == 0 and (depthwise or cb % groups == 0), (
        x_shape, vk, groups)
    assert nb % groups == 0 or depthwise, (cout, vn, groups)
    out_itemsize = out_itemsize or itemsize
    w_itemsize = w_itemsize or itemsize
    ho, _, _ = same_pads(h, kh, stride, dilation)
    wo, _, _ = same_pads(w, kw, stride, dilation)

    if kh == 1 and kw == 1 and groups == 1:
        # vsmm over flattened pixels: every sparse step gathers a fresh
        # (bm, vk) activation K-tile; identical for both impls.  The
        # stride-2 subsample is the only layout pass.
        m = n * ho * wo
        flops = 2 * m * nb * s_steps * vk * vn
        return TrafficReport(
            impl=impl,
            flops=flops,
            input_bytes=m * nb * s_steps * vk * itemsize,
            weight_bytes=nb * s_steps * vk * vn * w_itemsize,
            output_bytes=(m * cout * out_itemsize
                          + (m * cout * out_itemsize if residual else 0)),
            build_bytes=(2 * m * c * itemsize if stride != 1 else 0),
        )

    bh = min(bh, ho)
    hop = _round_up(ho, bh)
    hb = hop // bh
    res_bytes = n * hop * wo * cout * out_itemsize if residual else 0
    ke_h = (kh - 1) * dilation + 1
    ke_w = (kw - 1) * dilation + 1
    if impl == "halo":
        rows = stride * (hop - 1) + ke_h
        bwp = _round_up(stride * (wo - 1) + ke_w, 8)
        if depthwise:
            assert vk == 1 and cout == c, (x_shape, cout, vk, groups)
            est = dw_halo_kernel_cost(
                n=n, hop=hop, w_out=wo, kh=kh, stride=stride, bwp=bwp,
                bh=bh, nb=nb, s_steps=s_steps, vc=vn, dilation=dilation,
                in_itemsize=itemsize, w_itemsize=w_itemsize,
                out_itemsize=out_itemsize, residual_bytes=res_bytes,
            )
            input_bytes = n * hb * nb * (stride * (bh - 1) + ke_h) * bwp \
                * vn * itemsize
        else:
            cbg = cb // groups  # cin tiles reachable from one strip
            resident = use_resident_halo(hop, groups)
            est = halo_kernel_cost(
                n=n, hop=hop, w_out=wo, kh=kh, stride=stride, bwp=bwp, bh=bh,
                nb=nb, s_steps=s_steps, cb=cbg, vk=vk, vn=vn,
                dilation=dilation, resident=resident,
                in_itemsize=itemsize, w_itemsize=w_itemsize,
                out_itemsize=out_itemsize, residual_bytes=res_bytes,
            )
            hh = stride * (bh - 1) + ke_h
            if resident:
                # tiny-feature-map layout: the whole-cin halo block is
                # fetched once per (image, row-block), never per strip
                input_bytes = n * hb * hh * bwp * cb * vk * itemsize
            else:
                input_bytes = (n * hb * nb * min(s_steps, cbg) * hh * bwp
                               * vk * itemsize)
        # one pad: read the input, write the padded copy
        build = n * c * (h * w + rows * bwp) * itemsize
    elif impl == "stack":
        bw = _round_up(wo + ((kw - 1) * dilation) // stride, 8)
        if depthwise:
            assert vk == 1 and cout == c, (x_shape, cout, vk, groups)
            est = dw_stack_kernel_cost(
                n=n, hop=hop, w_out=wo, bw=bw, bh=bh, nb=nb,
                s_steps=s_steps, vc=vn, in_itemsize=itemsize,
                w_itemsize=w_itemsize, out_itemsize=out_itemsize,
                residual_bytes=res_bytes,
            )
            input_bytes = n * hb * nb * s_steps * bh * bw * vn * itemsize
        else:
            est = stack_kernel_cost(
                n=n, hop=hop, w_out=wo, bw=bw, bh=bh, nb=nb,
                s_steps=s_steps, vk=vk, vn=vn, in_itemsize=itemsize,
                w_itemsize=w_itemsize, out_itemsize=out_itemsize,
                residual_bytes=res_bytes,
            )
            input_bytes = n * hb * nb * s_steps * bh * bw * vk * itemsize
        # the stack build: read the input once (pad+gather fuse), write
        # kh*stride output-sized planes
        build = n * c * (h * w + kh * stride * hop * bw) * itemsize
    else:
        raise ValueError(f"impl must be 'halo' or 'stack', got {impl!r}")

    weight_bytes = nb * s_steps * vk * vn * w_itemsize
    output_bytes = n * hop * wo * cout * out_itemsize + res_bytes
    assert input_bytes + weight_bytes + output_bytes == est["bytes_accessed"], (
        "traffic model drifted from the kernel cost formula")
    return TrafficReport(
        impl=impl,
        flops=est["flops"],
        input_bytes=input_bytes,
        weight_bytes=weight_bytes,
        output_bytes=output_bytes,
        build_bytes=build,
    )


def network_traffic_reports(
    traffic: list[tuple], sparse: dict, *, bh: int = 8,
    impls: tuple[str, ...] = ("halo", "stack"),
) -> list[tuple[str, dict]]:
    """Per-layer DRAM traffic for one network's conv traffic, per impl.

    ``traffic`` is `models.graph.collect_conv_traffic`'s record —
    (name, conv input NHWC, weight, stride, groups, dilation) per conv
    layer (the trailing geometry fields are optional) — and ``sparse`` the
    `sparsify` dict giving each layer's encoded geometry (tile counts,
    vk/vn, cin padding).  An int8 entry (``sparsify(dtype="int8")``) is
    modeled with int8 activations and weights and f32 outputs.  Returns
    [(name, {impl: TrafficReport})].
    """
    out = []
    for name, x, w, stride, *gd in traffic:
        groups = gd[0] if gd else 1
        dilation = gd[1] if len(gd) > 1 else 1
        shape = tuple(x.shape)
        if len(shape) == 3:
            shape = (1, *shape)
        n, h, width, cin = shape
        kh, kw = tuple(w.shape)[:2]
        entry = sparse[name]
        nb, s_steps, vk, vn = (int(d) for d in entry.vs.vals.shape)
        item = entry.vs.vals.element_size()
        x_shape = (n, h, width, cin + entry.cin_pad)
        out.append((name, {
            impl: conv_layer_traffic(
                x_shape, kh=kh, kw=kw, stride=stride, groups=groups,
                dilation=dilation, cout=nb * vn,
                s_steps=s_steps, vk=vk, vn=vn, bh=bh, impl=impl,
                itemsize=item, w_itemsize=item, out_itemsize=4,
            )
            for impl in impls
        }))
    return out


def network_cycle_reports(traffic: list[tuple], pe: PEConfig
                          ) -> list[tuple[str, CycleReport]]:
    """Per-layer cycle reports for one network's conv traffic.

    ``traffic`` is the record produced by `models.graph.collect_conv_traffic`
    — (name, conv input, weight, stride, groups, dilation) per conv layer,
    in execution order; the input may be (N, H, W, Cin) (the leading image
    is used, the paper's single-image accounting) or (H, W, Cin).
    """
    reports = []
    for name, x, w, stride, *gd in traffic:
        groups = gd[0] if gd else 1
        dilation = gd[1] if len(gd) > 1 else 1
        if x.ndim == 4:
            x = x[0]
        reports.append((name, conv_layer_cycles(
            x, w, pe, stride=stride, groups=groups, dilation=dilation)))
    return reports


def load_calibration(backend: str | None = None,
                     path: str | None = None) -> CalibConstants:
    """The fitted cost-model constants for ``backend`` ("cuda" or "cpu";
    default: "cuda" where a card is visible) — `core.calibration`'s
    ``CalibConstants`` from ``src/repro_torch/baselines/CALIB_<backend>
    .json``, or the uncalibrated defaults when none exists.  Re-fit with
    ``calibrate_torch.py --fit``."""
    from .calibration import load_constants
    return load_constants(backend, path=path)


def predicted_layer_time_s(traffic: TrafficReport, *, nb: int, s_steps: int,
                           blocks: int, vk: int, vn: int,
                           constants: CalibConstants | None = None
                           ) -> float:
    """Calibrated time prediction for one layer.

    ``blocks`` is the reference kernel's spatial grid sweep per strip
    (row-blocks for a conv, M-tiles for the matmul path); the remaining
    geometry comes from the encoded weight.  ``constants`` defaults to
    `load_calibration()`."""
    from .calibration import layer_features, predict_time_s

    c = constants if constants is not None else load_calibration()
    feat = layer_features(flops=traffic.flops,
                          bytes_accessed=traffic.bytes_accessed, nb=nb,
                          s_steps=s_steps, blocks=blocks, vk=vk, vn=vn)
    return predict_time_s(feat, c)


def aggregate(reports: list[CycleReport]) -> CycleReport:
    return CycleReport(
        dense=sum(r.dense for r in reports),
        vscnn=sum(r.vscnn for r in reports),
        ideal_vector=sum(r.ideal_vector for r in reports),
        ideal_fine=sum(r.ideal_fine for r in reports),
        macs_nonzero=sum(r.macs_nonzero for r in reports),
        macs_dense=sum(r.macs_dense for r in reports),
    )


def table1_example() -> CycleReport:
    """The paper's 5x5 micro example (Table I / Fig. 7-8).

    Input column B (the 2nd of 5) is all zero; weight column WC (kx=2) is all
    zero.  Expect 15 dense cycles and 8 sparse cycles.
    """
    x = np.ones((5, 5, 1))
    x[:, 1, 0] = 0.0  # column B zero
    w = np.ones((3, 3, 1, 1))
    w[:, 2, 0, 0] = 0.0  # column WC zero
    return conv_layer_cycles(x, w, PEConfig(blocks=1, rows=5, cols=3))
