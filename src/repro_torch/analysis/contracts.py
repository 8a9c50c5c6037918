"""vscheck pass 2 — kernel contract checking by abstract index-map
evaluation (the port's copy of `repro/analysis/contracts.py`).

For every `ConvSite`/`FCSite` the IR walk produced, build the
`kernels.plan.KernelPlan` each impl would dispatch under the layout and
cost contract the port shares with the reference ('halo' and 'stack' for
convs, vsmm for FC heads) and prove, without executing anything:

  VSC201  every block a grid step can read/write stays inside the padded
          buffer — the contract's own index_map evaluated over
          `analysis.intervals.Interval` grid axes and the full stored-
          tile-id range (so the proof covers every balanced encoding of
          the layer, not one sampled mask);
  VSC202  the DRAM bytes the contract's cost formula claims equal
          the bytes re-derived from the abstract access set — the same
          index_map enumerated over the concrete grid with the canonical
          cin-major idx, block fetches counted under each buffer's
          declared DMA policy;
  VSC203  `core.accel_model.conv_layer_traffic`'s per-column model
          (input/weight/output/flops/build) equals the same derivation
          quoted at the logical (un-padded) extents;
  VSC204  a faithful simulation of the revisit rule
          (skip when a step's offsets equal the immediately previous
          step's) never exceeds the contract's input-fetch count — the
          cost formulas are sound upper bounds.  Input buffer only: the
          weight/output terms are deliberate once-per-unique-tile
          idealizations shared with the traffic model (see
          `kernels.plan`);
  VSC205  claimed FLOPs == flops_per_step * grid size.

It proves that contract, not the CUDA launch plans
(`kernels.vsconv.conv_plan`, `kernels.vsmm.vsmm_plan`,
`kernels.vsconv_dw.dw_tile`), which tile the same layouts differently.

The canonical idx is the one `models.graph.sparse_conv_from_dense`
emits: ascending stored-tile ids re-sorted cin-major per strip — the
order the halo cost formula's min(S, CB) fetch floor relies on.

Every site is proven under *both* dtype contracts: f32 (activation /
weight / output all 4 bytes) and int8 (int8 activations+weights, f32
output, a per-cout dequant-scale operand whose tile rides the excluded
DMA policy like bias).  Int8 rows carry a ``:int8`` path tag.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.accel_model import conv_layer_traffic
from repro_torch.kernels import plan as plan_mod
from repro_torch.kernels.plan import BufferAccess, KernelPlan

from .diagnostics import Report
from .intervals import AbstractIdx, Interval
from .ir import ConvSite, FCSite, NetCheck

__all__ = [
    "PlanSummary", "canonical_conv_idx", "canonical_tap_idx",
    "check_plan", "check_conv_site", "check_fc_site", "check_contracts",
]


@dataclasses.dataclass(frozen=True)
class PlanSummary:
    """One verified kernel invocation (a CLI/report row)."""

    path: str
    variant: str       # 'halo' | 'stack' | 'fc'
    kind: str          # plan kind actually dispatched
    grid: tuple[int, int, int]
    bytes_derived: int
    flops: int


def canonical_conv_idx(nb: int, s_steps: int, cbg: int) -> np.ndarray:
    """The idx table `sparse_conv_from_dense` would emit for the first
    ``s_steps`` stored tiles of every strip: ascending tile ids re-sorted
    cin-major (primary key tile % cbg, secondary tile // cbg) — the order
    `core.vector_sparse.conv_cin_major` produces."""
    r = np.arange(s_steps, dtype=np.int64)
    order = np.lexsort((r // cbg, r % cbg))
    return np.tile(r[order], (nb, 1))


def canonical_tap_idx(nb: int, s_steps: int) -> np.ndarray:
    """Depthwise / vsmm idx: bare ascending ids per strip."""
    return np.tile(np.arange(s_steps, dtype=np.int64), (nb, 1))


# --------------------------------------------------------------------------
# Abstract evaluation machinery
# --------------------------------------------------------------------------

def _grid_axes(grid: tuple[int, int, int]
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The full grid in lexicographic order, last axis fastest — the order
    the reference's kernels iterate a row-major grid (the order VSC204's
    elision simulation depends on)."""
    a0, a1, a2 = np.meshgrid(
        np.arange(grid[0], dtype=np.int64),
        np.arange(grid[1], dtype=np.int64),
        np.arange(grid[2], dtype=np.int64), indexing="ij")
    return a0.ravel(), a1.ravel(), a2.ravel()


def _offsets(plan: KernelPlan, buf: BufferAccess, idx: np.ndarray
             ) -> np.ndarray:
    """(G, rank) element offsets of every grid step's block, lex order."""
    a0, a1, a2 = _grid_axes(plan.grid)
    out = buf.index_map(a0, a1, a2, idx)
    cols = [np.broadcast_to(np.asarray(o, dtype=np.int64), a0.shape)
            for o in out]
    offs = np.stack(cols, axis=1)
    if not buf.unblocked:
        offs = offs * np.asarray(buf.block, dtype=np.int64)
    return offs


def _contract_fetches(plan: KernelPlan, buf: BufferAccess,
                      offs: np.ndarray) -> int:
    """Block DMAs under the buffer's declared counting policy."""
    if buf.policy == "per_step":
        return int(offs.shape[0])
    if buf.policy == "distinct":
        return int(np.unique(offs, axis=0).shape[0])
    if buf.policy == "sweep_distinct":
        axes = _grid_axes(plan.grid)
        key = np.zeros_like(axes[0])
        for ax in buf.sweep_axes:
            key = key * plan.grid[ax] + axes[ax]
        rows = np.concatenate([key[:, None], offs], axis=1)
        return int(np.unique(rows, axis=0).shape[0])
    raise ValueError(f"policy {buf.policy!r} has no fetch count")


def _faithful_fetches(offs: np.ndarray) -> int:
    """The revisit rule: a DMA is issued whenever a step's offsets differ
    from the immediately previous step's (plus the first)."""
    if offs.shape[0] == 0:
        return 0
    changed = np.any(offs[1:] != offs[:-1], axis=1)
    return 1 + int(changed.sum())


def _bounds_violations(plan: KernelPlan, buf: BufferAccess
                       ) -> list[tuple[int, Interval]]:
    """Interval-evaluate the index map over the whole grid and the whole
    stored-tile-id range; every axis whose block can escape the padded
    buffer is a violation."""
    axes = tuple(Interval(0, g - 1) for g in plan.grid)
    out = buf.index_map(*axes, AbstractIdx(plan.kb))
    bad: list[tuple[int, Interval]] = []
    for ax, o in enumerate(out):
        iv = Interval.of(o)
        if buf.unblocked:
            ok = iv.lo >= 0 and iv.hi + buf.block[ax] <= buf.dims[ax]
        else:
            ok = iv.lo >= 0 and (iv.hi + 1) * buf.block[ax] <= buf.dims[ax]
        if not ok:
            bad.append((ax, iv))
    return bad


def _prod(xs: tuple[int, ...]) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


def _at_valid(v: int, buf: BufferAccess, path: str) -> int:
    """Re-quote a padded-extent total at the buffer's logical extents
    (exact by construction: wrappers pad whole axes)."""
    num, den = _prod(buf.valid), _prod(buf.dims)
    scaled = v * num
    assert scaled % den == 0, (path, buf.name, v, buf.valid, buf.dims)
    return scaled // den


def check_plan(plan: KernelPlan, *, path: str, rep: Report,
               idx: np.ndarray) -> dict[str, int]:
    """VSC201/202/204/205 for one kernel plan.

    Returns the per-buffer derived byte columns (padded extents) for the
    caller's model comparison; {} is still returned on failure.
    """
    g_total = _prod(plan.grid)
    cols: dict[str, int] = {}
    total = 0
    for buf in plan.buffers:
        for ax, iv in _bounds_violations(plan, buf):
            rep.error(
                "VSC201", path,
                f"{plan.kind}: {buf.name} axis {ax} offset {iv} + block "
                f"{buf.block[ax]} escapes dim {buf.dims[ax]}")
        if buf.policy == "excluded":
            continue
        offs = _offsets(plan, buf, idx)
        fetches = _contract_fetches(plan, buf, offs)
        nbytes = fetches * buf.block_elems * buf.itemsize
        cols[buf.name] = nbytes
        total += nbytes
        if buf.name == "input":
            faithful = _faithful_fetches(offs)
            if faithful > fetches:
                rep.error(
                    "VSC204", path,
                    f"{plan.kind}: faithful DMA-elision simulation issues "
                    f"{faithful} input fetches, the {buf.policy} contract "
                    f"only budgets {fetches}",
                    hint="the stored-tile order no longer matches the "
                         "cost formula's revisit assumption (cin-major)")
    if total != plan.cost["bytes_accessed"]:
        rep.error(
            "VSC202", path,
            f"{plan.kind}: abstract access set moves {total} bytes, the "
            f"kernel CostEstimate claims {plan.cost['bytes_accessed']}")
    derived_flops = plan.flops_per_step * g_total
    if derived_flops != plan.cost["flops"]:
        rep.error(
            "VSC205", path,
            f"{plan.kind}: grid issues {derived_flops} FLOPs, the kernel "
            f"CostEstimate claims {plan.cost['flops']}")
    return cols


def _plan_idx(plan: KernelPlan, *, cbg: int) -> np.ndarray:
    if plan.kind in ("halo", "resident", "stack"):
        return canonical_conv_idx(plan.nb, plan.s_steps, cbg)
    return canonical_tap_idx(plan.nb, plan.s_steps)


def check_conv_site(site: ConvSite, *, rep: Report, itemsize: int = 4,
                    w_itemsize: int | None = None,
                    out_itemsize: int | None = None) -> list[PlanSummary]:
    """Both conv impls of one site: plan + prove + compare to the traffic
    model column by column (VSC203).

    ``itemsize``/``w_itemsize``/``out_itemsize`` select the dtype
    contract — (4, 4, 4) is f32, (1, 1, 4) is the int8 path (int8
    activations+weights dequantized to f32 in the epilogue, so the plan
    additionally carries the excluded per-cout scale tile).
    """
    out: list[PlanSummary] = []
    g = site.geom
    n, h, w, c = site.x_shape
    w_itemsize = w_itemsize or itemsize
    out_itemsize = out_itemsize or itemsize
    int8 = w_itemsize == 1
    tag = ":int8" if int8 else ""
    for impl in ("halo", "stack"):
        plan = plan_mod.conv_plan(
            site.x_shape, kh=site.kh, kw=site.kw, stride=site.stride,
            groups=site.groups, dilation=site.dilation, cout=site.cout,
            s_steps=site.s_steps, vk=g.vk, vn=g.vn, impl=impl,
            has_bias=True, has_residual=site.has_residual,
            has_scale=int8, itemsize=itemsize, w_itemsize=w_itemsize,
            out_itemsize=out_itemsize,
        )
        assert plan.kb == g.kb, (site.path, plan.kb, g.kb)
        path = f"{site.path}[{impl}{tag}]"
        cbg = 1 if g.depthwise else (c // g.vk) // site.groups
        cols = check_plan(plan, path=path, rep=rep,
                          idx=_plan_idx(plan, cbg=cbg))
        model = conv_layer_traffic(
            site.x_shape, kh=site.kh, kw=site.kw, stride=site.stride,
            groups=site.groups, dilation=site.dilation, cout=site.cout,
            s_steps=site.s_steps, vk=g.vk, vn=g.vn, impl=impl,
            itemsize=itemsize, w_itemsize=w_itemsize,
            out_itemsize=out_itemsize, residual=site.has_residual,
        )
        # quote the derived columns at logical extents (the vsmm row axis
        # is the only padded one) and derive the layout-pass bytes from
        # the plan's input buffer dims
        if plan.kind == "vsmm":
            x_buf, o_buf = plan.buffer("input"), plan.buffer("output")
            m_valid, mp = o_buf.valid[0], o_buf.dims[0]
            derived = {
                "input": _at_valid(cols["input"], x_buf, path),
                "weights": cols["weights"],
                "output": _at_valid(cols["output"], o_buf, path)
                + (_at_valid(cols["residual"], plan.buffer("residual"), path)
                   if site.has_residual else 0),
                "flops": plan.flops_per_step * _prod(plan.grid)
                * m_valid // mp,
                "build": (2 * m_valid * c * itemsize
                          if site.stride != 1 else 0),
            }
        else:
            in_dims = plan.buffer("input").dims
            derived = {
                "input": cols["input"],
                "weights": cols["weights"],
                "output": cols["output"] + cols.get("residual", 0),
                "flops": plan.flops_per_step * _prod(plan.grid),
                "build": (n * h * w * c + _prod(in_dims)) * itemsize,
            }
        expect = {
            "input": model.input_bytes,
            "weights": model.weight_bytes,
            "output": model.output_bytes,
            "flops": model.flops,
            "build": model.build_bytes,
        }
        bad = [k for k in expect if derived[k] != expect[k]]
        if bad:
            detail = ", ".join(
                f"{k}: derived {derived[k]} != model {expect[k]}"
                for k in bad)
            rep.error("VSC203", path,
                      f"{plan.kind}: traffic model drift — {detail}")
        out.append(PlanSummary(
            path=path, variant=impl, kind=plan.kind, grid=plan.grid,
            bytes_derived=sum(cols.values()),
            flops=plan.flops_per_step * _prod(plan.grid)))
    return out


def check_fc_site(site: FCSite, *, rep: Report, itemsize: int = 4,
                  w_itemsize: int | None = None,
                  out_itemsize: int | None = None) -> list[PlanSummary]:
    """The vsmm plan of one FC head (dense VSC116 layers are skipped —
    no sparse kernel runs for them).  Dtype contract selection as in
    `check_conv_site`."""
    g = site.geom
    if g is None:
        return []
    w_itemsize = w_itemsize or itemsize
    out_itemsize = out_itemsize or itemsize
    int8 = w_itemsize == 1
    plan = plan_mod.fc_plan(
        m=site.m, k=site.din, s_steps=site.s_steps, vk=g.vk, vn=g.vn,
        nb=g.nb, has_bias=True, has_scale=int8, itemsize=itemsize,
        w_itemsize=w_itemsize, out_itemsize=out_itemsize,
    )
    path = f"{site.path}[fc:int8]" if int8 else f"{site.path}[fc]"
    cols = check_plan(plan, path=path, rep=rep,
                      idx=_plan_idx(plan, cbg=1))
    return [PlanSummary(
        path=path, variant="fc", kind=plan.kind, grid=plan.grid,
        bytes_derived=sum(cols.values()),
        flops=plan.flops_per_step * _prod(plan.grid))]


# activation / weight / output itemsizes of each verified dtype contract
DTYPE_CONTRACTS: dict[str, tuple[int, int, int]] = {
    "f32": (4, 4, 4),
    "int8": (1, 1, 4),
}


def check_contracts(nc: NetCheck, *, itemsize: int = 4,
                    dtypes: tuple[str, ...] = ("f32", "int8")
                    ) -> tuple[Report, list[PlanSummary]]:
    """Pass 2 over everything pass 1 surfaced, once per dtype contract.

    ``itemsize`` overrides the f32 contract's uniform itemsize (kept for
    callers probing odd widths); the int8 pass always runs (1, 1, 4).
    """
    rep = Report()
    rows: list[PlanSummary] = []
    for dt in dtypes:
        a_i, w_i, o_i = DTYPE_CONTRACTS[dt]
        if dt == "f32":
            a_i = w_i = o_i = itemsize
        for site in nc.conv_sites:
            rows.extend(check_conv_site(
                site, rep=rep, itemsize=a_i, w_itemsize=w_i,
                out_itemsize=o_i))
        for fsite in nc.fc_sites:
            rows.extend(check_fc_site(
                fsite, rep=rep, itemsize=a_i, w_itemsize=w_i,
                out_itemsize=o_i))
    return rep, rows
