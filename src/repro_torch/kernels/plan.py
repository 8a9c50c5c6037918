"""Static kernel plans: the reference's dispatch of `ops.vsconv` /
`ops.vsmm` re-derived from pure geometry, with no arrays and no kernel
execution (the port's copy of `repro/kernels/plan.py`).

A `KernelPlan` is everything vscheck's pass 2 (`analysis.contracts`) needs
to prove one invocation of the reference's layout and cost contract
correct ahead of time:

  * the grid and every buffer's `BufferAccess` — block shape, buffer
    dims, the contract's `index_map` (the named factories in
    `kernels.vsconv`, `kernels.vsconv_dw` and `kernels.vsmm`), and the
    DMA-counting policy its cost formula assumes;
  * the cost the contract claims for it (the port's copies of the cost
    formulas, at the same padded extents).

`conv_plan` / `fc_plan` replicate the reference wrappers' dispatch —
1x1-via-vsmm routing, depthwise detection, resident-halo selection,
bh/hop/bm padding — from static shapes only, through the port's
`halo_layout_dims`, `stack_layout_dims` and cost functions.

Two plans share a name: `conv_plan` here is the reference's contract
plan; `kernels.vsconv.conv_plan` is the CUDA launch plan (rows, splits)
of the generic conv body.  Pass 2 proves the layout and cost contract that
the port shares with the reference, not the CUDA launch plans
(`kernels.vsconv.conv_plan`, `kernels.vsmm.vsmm_plan`,
`kernels.vsconv_dw.dw_tile`).

DMA-counting policies (how the cost contract counts block fetches):

  ``distinct``        one DMA per globally distinct offset tuple — weight
                      stream, output/residual tiles, the resident and
                      depthwise halo blocks.
  ``sweep_distinct``  distinct offsets within each sweep of the inner
                      grid axes (outer ``sweep_axes`` fixed), summed over
                      sweeps — the streaming halo input, whose
                      min(S, CB) per-(strip, row-block) fetch floor
                      relies on a revisited block within a sweep costing
                      no new DMA, but not across strips.
  ``per_step``        one DMA per grid step — the row-tap stack input and
                      the vsmm activation gather, whose block index
                      changes (in the model) every sparse step.
  ``excluded``        not part of the byte contract (the (1, vn) bias
                      and int8 dequant-scale tiles: one tile per strip,
                      noise next to the other terms) — bounds are still
                      proven.

The faithful revisit rule — skip the DMA whenever a step's offsets equal
the immediately previous step's — is simulated separately by the
analyzer and asserted ``<=`` the policy count (the contract must be a
sound upper bound; rule VSC204).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from repro_torch.core.sparse_ops import same_pads

from .vsconv import (
    conv_bias_index_map, conv_out_index_map, conv_weight_index_map,
    halo_in_index_map, halo_kernel_cost, halo_layout_dims,
    resident_in_index_map, stack_in_index_map, stack_kernel_cost,
    stack_layout_dims, use_resident_halo,
)
from .vsconv_dw import (
    dw_halo_in_index_map, dw_halo_kernel_cost, dw_stack_in_index_map,
    dw_stack_kernel_cost,
)
from .vsmm import (
    vsmm_bias_index_map, vsmm_kernel_cost, vsmm_out_index_map,
    vsmm_w_index_map, vsmm_x_index_map,
)

__all__ = ["BufferAccess", "KernelPlan", "conv_plan", "fc_plan", "POLICIES"]

IndexMap = Callable[..., tuple[Any, ...]]

POLICIES = ("distinct", "sweep_distinct", "per_step", "excluded")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class BufferAccess:
    """One operand of a contract kernel: its block geometry plus the
    DMA-counting policy the cost contract assumes for it.

    ``dims`` is the full (padded) buffer shape; ``valid`` the logically
    meaningful extents per axis (== dims except where a wrapper padded —
    the vsmm row axis), letting the analyzer quote bytes both at the
    kernel's padded extents and at `conv_layer_traffic`'s logical ones.
    ``unblocked`` means the index map yields element offsets; otherwise
    block indices scaled by ``block``.
    """

    name: str
    block: tuple[int, ...]
    dims: tuple[int, ...]
    valid: tuple[int, ...]
    index_map: IndexMap
    policy: str
    itemsize: int
    unblocked: bool = False
    sweep_axes: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"unknown DMA policy {self.policy!r}")
        if len(self.block) != len(self.dims) or len(self.dims) != len(
                self.valid):
            raise ValueError(
                f"{self.name}: rank mismatch {self.block}/{self.dims}")

    @property
    def block_elems(self) -> int:
        n = 1
        for b in self.block:
            n *= b
        return n


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """The statically derived shape of one kernel invocation."""

    kind: str                      # halo|resident|stack|dw_halo|dw_stack|vsmm
    grid: tuple[int, int, int]     # (g0, g1, g2); g2 is the sparse-step axis
    kb: int                        # stored-tile-id bound (idx values < kb)
    nb: int                        # strips (the idx table is (nb, s_steps))
    s_steps: int
    buffers: tuple[BufferAccess, ...]
    cost: dict[str, int]           # the contract's claim: flops, bytes_accessed
    flops_per_step: int            # 2 * MACs issued by one grid step

    def buffer(self, name: str) -> BufferAccess:
        for b in self.buffers:
            if b.name == name:
                return b
        raise KeyError(name)


def conv_plan(
    x_shape: Sequence[int],
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
    has_bias: bool = False,
    has_residual: bool = False,
    has_scale: bool = False,
    itemsize: int = 4,
    w_itemsize: int | None = None,
    out_itemsize: int | None = None,
) -> KernelPlan:
    """The reference's `ops.vsconv` dispatch from static geometry (the
    contract plan; the CUDA launch plan is `kernels.vsconv.conv_plan`).

    ``x_shape`` is the *encoded* NHWC input (Cin a vk multiple, pad
    channels included), ``cout`` the encoded output width (a vn multiple)
    — the same conventions as `core.accel_model.conv_layer_traffic`, whose
    byte totals the resulting plan must reproduce.

    The dtype axis: ``itemsize`` is the activation/input width,
    ``w_itemsize`` the stored weight width (defaults to ``itemsize``;
    1 for the int8 kernels), ``out_itemsize`` the output width (defaults
    to ``itemsize``; the int8 path emits f32, so 4).  The f32 bias, the
    f32 residual and the f32 dequant ``scale`` (``has_scale``) are always
    ``out_itemsize`` wide.
    """
    n, h, w, c = (int(d) for d in x_shape)
    if impl not in ("halo", "stack"):
        raise ValueError(f"impl must be 'halo' or 'stack', got {impl!r}")
    assert c % vk == 0 and cout % vn == 0, (x_shape, cout, vk, vn)
    out_itemsize = out_itemsize or itemsize
    w_itemsize = w_itemsize or itemsize
    nb = cout // vn
    cb = c // vk
    depthwise = groups > 1 and groups == c and vk == 1 and cout == c
    assert c % groups == 0 and (depthwise or cb % groups == 0), (
        x_shape, vk, groups)

    if kh == 1 and kw == 1 and groups == 1:
        ho = -(-h // stride)
        wo = -(-w // stride)
        return fc_plan(
            m=n * ho * wo, k=c, s_steps=s_steps, vk=vk, vn=vn, nb=nb,
            has_bias=has_bias, has_residual=has_residual,
            has_scale=has_scale, itemsize=itemsize, w_itemsize=w_itemsize,
            out_itemsize=out_itemsize,
        )

    ho, _, _ = same_pads(h, kh, stride, dilation)
    wo, _, _ = same_pads(w, kw, stride, dilation)
    bh = min(bh, ho)
    hop = _round_up(ho, bh)
    hb = hop // bh
    hh = stride * (bh - 1) + (kh - 1) * dilation + 1
    res_bytes = n * hop * wo * cout * out_itemsize if has_residual else 0

    out_buf = BufferAccess(
        name="output",
        block=(1, bh, wo, vn),
        dims=(n, hop, wo, cout),
        valid=(n, hop, wo, cout),
        index_map=conv_out_index_map(hb),
        policy="distinct",
        itemsize=out_itemsize,
    )
    extras: list[BufferAccess] = []
    if has_scale:
        extras.append(BufferAccess(
            name="scale", block=(1, vn), dims=(nb, vn), valid=(nb, vn),
            index_map=conv_bias_index_map(), policy="excluded",
            itemsize=out_itemsize,
        ))
    if has_bias:
        extras.append(BufferAccess(
            name="bias", block=(1, vn), dims=(nb, vn), valid=(nb, vn),
            index_map=conv_bias_index_map(), policy="excluded",
            itemsize=out_itemsize,
        ))
    if has_residual:
        extras.append(dataclasses.replace(
            out_buf, name="residual", itemsize=out_itemsize))

    if depthwise:
        # per-channel tap kernels: strip j IS the channel tile, vk==1,
        # vn == the channel-tile width, idx values are bare tap ids
        kb = kh * kw
        w_buf = BufferAccess(
            name="weights", block=(1, 1, 1, vn), dims=(nb, s_steps, 1, vn),
            valid=(nb, s_steps, 1, vn), index_map=conv_weight_index_map(),
            policy="distinct", itemsize=w_itemsize,
        )
        if impl == "halo":
            rows, bwp = halo_layout_dims(
                h, w, kh=kh, kw=kw, stride=stride, dilation=dilation,
                h_out=hop)
            in_buf = BufferAccess(
                name="input", block=(1, hh, bwp, 1, vn),
                dims=(n, rows, bwp, nb, vn), valid=(n, rows, bwp, nb, vn),
                index_map=dw_halo_in_index_map(hb, stride, bh),
                policy="distinct", itemsize=itemsize, unblocked=True,
            )
            cost = dw_halo_kernel_cost(
                n=n, hop=hop, w_out=wo, kh=kh, stride=stride, bwp=bwp, bh=bh,
                nb=nb, s_steps=s_steps, vc=vn, dilation=dilation,
                in_itemsize=itemsize, w_itemsize=w_itemsize,
                out_itemsize=out_itemsize, residual_bytes=res_bytes,
            )
            kind = "dw_halo"
        else:
            planes, bw = stack_layout_dims(
                h, w, kh=kh, kw=kw, stride=stride, dilation=dilation,
                h_out=hop)
            in_buf = BufferAccess(
                name="input", block=(1, 1, bh, bw, vn),
                dims=(n, planes, hop, bw, cout),
                valid=(n, planes, hop, bw, cout),
                index_map=dw_stack_in_index_map(hb, kw, stride, dilation),
                policy="per_step", itemsize=itemsize,
            )
            cost = dw_stack_kernel_cost(
                n=n, hop=hop, w_out=wo, bw=bw, bh=bh, nb=nb, s_steps=s_steps,
                vc=vn, in_itemsize=itemsize, w_itemsize=w_itemsize,
                out_itemsize=out_itemsize, residual_bytes=res_bytes,
            )
            kind = "dw_stack"
        flops_per_step = 2 * bh * wo * vn
        grid = (nb, n * hb, s_steps)
        return KernelPlan(
            kind=kind, grid=grid, kb=kb, nb=nb, s_steps=s_steps,
            buffers=(in_buf, w_buf, out_buf, *extras), cost=cost,
            flops_per_step=flops_per_step,
        )

    cbg = cb // groups   # cin tiles reachable from one strip
    spg = nb // groups   # output strips per group
    assert nb % groups == 0, (cout, vn, groups)
    kb = kh * kw * cbg
    flops_per_step = 2 * bh * wo * vk * vn
    if impl == "halo":
        rows, bwp = halo_layout_dims(
            h, w, kh=kh, kw=kw, stride=stride, dilation=dilation, h_out=hop)
        resident = use_resident_halo(hop, groups)
        cost = halo_kernel_cost(
            n=n, hop=hop, w_out=wo, kh=kh, stride=stride, bwp=bwp, bh=bh,
            nb=nb, s_steps=s_steps, cb=cbg, vk=vk, vn=vn, dilation=dilation,
            resident=resident, in_itemsize=itemsize,
            w_itemsize=w_itemsize,
            out_itemsize=out_itemsize, residual_bytes=res_bytes,
        )
        w_buf = BufferAccess(
            name="weights", block=(1, 1, vk, vn), dims=(nb, s_steps, vk, vn),
            valid=(nb, s_steps, vk, vn),
            index_map=conv_weight_index_map(resident=resident),
            policy="distinct", itemsize=w_itemsize,
        )
        if resident:
            in_buf = BufferAccess(
                name="input", block=(1, hh, bwp, cb, vk),
                dims=(n, rows, bwp, cb, vk), valid=(n, rows, bwp, cb, vk),
                index_map=resident_in_index_map(hb, stride, bh),
                policy="distinct", itemsize=itemsize, unblocked=True,
            )
            grid = (n * hb, nb, s_steps)
            out_buf = dataclasses.replace(
                out_buf, index_map=conv_out_index_map(hb, resident=True))
            extras = [
                dataclasses.replace(
                    b,
                    index_map=(conv_bias_index_map(resident=True)
                               if b.name in ("bias", "scale")
                               else conv_out_index_map(hb, resident=True)))
                for b in extras
            ]
            kind = "resident"
        else:
            in_buf = BufferAccess(
                name="input", block=(1, hh, bwp, 1, vk),
                dims=(n, rows, bwp, cb, vk), valid=(n, rows, bwp, cb, vk),
                index_map=halo_in_index_map(hb, stride, bh, cbg, spg),
                policy="sweep_distinct", itemsize=itemsize, unblocked=True,
                sweep_axes=(0, 1),
            )
            grid = (nb, n * hb, s_steps)
            kind = "halo"
    else:
        planes, bw = stack_layout_dims(
            h, w, kh=kh, kw=kw, stride=stride, dilation=dilation, h_out=hop)
        cost = stack_kernel_cost(
            n=n, hop=hop, w_out=wo, bw=bw, bh=bh, nb=nb, s_steps=s_steps,
            vk=vk, vn=vn, in_itemsize=itemsize, w_itemsize=w_itemsize,
            out_itemsize=out_itemsize, residual_bytes=res_bytes,
        )
        w_buf = BufferAccess(
            name="weights", block=(1, 1, vk, vn), dims=(nb, s_steps, vk, vn),
            valid=(nb, s_steps, vk, vn), index_map=conv_weight_index_map(),
            policy="distinct", itemsize=w_itemsize,
        )
        in_buf = BufferAccess(
            name="input", block=(1, 1, bh, bw, vk), dims=(n, planes, hop, bw, c),
            valid=(n, planes, hop, bw, c),
            index_map=stack_in_index_map(hb, cbg, spg, kw, stride, dilation),
            policy="per_step", itemsize=itemsize,
        )
        grid = (nb, n * hb, s_steps)
        kind = "stack"
    return KernelPlan(
        kind=kind, grid=grid, kb=kb, nb=nb, s_steps=s_steps,
        buffers=(in_buf, w_buf, out_buf, *extras), cost=cost,
        flops_per_step=flops_per_step,
    )


def fc_plan(
    *,
    m: int,
    k: int,
    s_steps: int,
    vk: int,
    vn: int,
    nb: int,
    bm: int = 256,
    has_bias: bool = False,
    has_residual: bool = False,
    has_scale: bool = False,
    itemsize: int = 4,
    w_itemsize: int | None = None,
    out_itemsize: int | None = None,
) -> KernelPlan:
    """The reference's `ops.vsmm` dispatch from static geometry: ``m``
    logical rows padded to a ``bm`` multiple exactly as the reference's
    wrapper pads (the plan's cost quotes the padded extents; ``valid``
    records the logical ones `conv_layer_traffic` uses for the 1x1-conv
    route)."""
    assert k % vk == 0, (k, vk)
    out_itemsize = out_itemsize or itemsize
    w_itemsize = w_itemsize or itemsize
    bm = min(bm, _round_up(m, 8))
    mp = _round_up(m, bm)
    kb = k // vk
    res_bytes = mp * nb * vn * out_itemsize if has_residual else 0
    x_buf = BufferAccess(
        name="input", block=(bm, vk), dims=(mp, k), valid=(m, k),
        index_map=vsmm_x_index_map(), policy="per_step", itemsize=itemsize,
    )
    w_buf = BufferAccess(
        name="weights", block=(1, 1, vk, vn), dims=(nb, s_steps, vk, vn),
        valid=(nb, s_steps, vk, vn), index_map=vsmm_w_index_map(),
        policy="distinct", itemsize=w_itemsize,
    )
    out_buf = BufferAccess(
        name="output", block=(bm, vn), dims=(mp, nb * vn),
        valid=(m, nb * vn), index_map=vsmm_out_index_map(),
        policy="distinct", itemsize=out_itemsize,
    )
    extras: list[BufferAccess] = []
    if has_scale:
        extras.append(BufferAccess(
            name="scale", block=(1, vn), dims=(nb, vn), valid=(nb, vn),
            index_map=vsmm_bias_index_map(), policy="excluded",
            itemsize=out_itemsize,
        ))
    if has_bias:
        extras.append(BufferAccess(
            name="bias", block=(1, vn), dims=(nb, vn), valid=(nb, vn),
            index_map=vsmm_bias_index_map(), policy="excluded",
            itemsize=out_itemsize,
        ))
    if has_residual:
        extras.append(dataclasses.replace(
            out_buf, name="residual", itemsize=out_itemsize))
    cost = vsmm_kernel_cost(
        m=mp, nb=nb, s_steps=s_steps, vk=vk, vn=vn, in_itemsize=itemsize,
        w_itemsize=w_itemsize, out_itemsize=out_itemsize,
        residual_bytes=res_bytes,
    )
    return KernelPlan(
        kind="vsmm", grid=(nb, mp // bm, s_steps), kb=kb, nb=nb,
        s_steps=s_steps, buffers=(x_buf, w_buf, out_buf, *extras), cost=cost,
        flops_per_step=2 * bm * vk * vn,
    )
