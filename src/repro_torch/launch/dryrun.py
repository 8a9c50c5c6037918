"""Dry run: count every (arch x shape) step on the meta device and write
its roofline row, for one card or for one rank of the production mesh.

The port of `repro/launch/dryrun.py`.  Per cell the reference builds the
step under the 16x16 pod's mesh (2x16x16 with ``--multipod``), lowers
and compiles it without allocating anything, prints its
``memory_analysis()`` per device (the proof that the cell fits) and
turns the compiled HLO into FLOPs, bytes and wire bytes per device
(`repro/utils/hlo.py`).  The port has no XLA program; per cell it

  1. with a mesh (``--mesh 16x16``, ``--multipod``) stands as one rank
     (``--rank``, 0 by default) of a world of 256 or 512 ranks that has
     no processes (`launch.mesh.fake_world`), and builds the step under
     ``use_mesh(mesh, TRAIN_RULES)`` as the reference does for every
     kind (`step_builders.build` with the mesh: params by the schema,
     optimizer state by `opt_state_axes`, batch and caches by their
     logical axes), each argument this rank's shards; without one it
     builds one card's whole step;
  2. runs it once on empty ``meta`` tensors under `utils.cost.CostCounter`:
     every op the rank would run on its local shards, the hand-written
     kernels as one op each at their rank-local shapes, and every
     collective with its wire bytes, with nothing allocated, launched or
     sent;
  3. reports the arguments' and the peak temporaries' bytes per device
     and whether they fit in the card's memory (``fits``);
  4. writes the roofline row (`utils.roofline.report`) against the
     card's datasheet row (`utils.roofline.HW`), the collective term
     priced per mesh dim at the datasheets' link rates: predictions for
     that card, not measurements.

A rank's count can depend on the rank: the ``sp`` flash kernel's causal
work at ``q_offset`` grows with the rank's sequence block, so the rank
counted is part of the row.  ``chip_smoke.py``'s ``dryrun`` phase holds
the meta count against the count of the same steps run on the card, one
card's and a one-rank 1x1 mesh's.  The grid is the reference's: every
registered LM arch at every pod shape of `configs.base.SHAPES`
(``train_4k`` is 256 x 4096 tokens); unsupported shapes are skipped with
`supported_shapes`'s reason.  One cell beyond the reference's: Qwen1.5-4B
with the vector-sparse FFN at ``prefill_32k`` and ``decode_32k``, the
paper's skip in the roofline (the sparse FFN does not train, as in the
reference).

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k \
      --mesh 16x16 [--rank 255]
  python -m repro_torch.launch.dryrun --all [--mesh 16x16 | --multipod] \
      [--optimized] [--out rows.json]

``--multipod`` is ``--mesh 2x16x16`` and writes ``*_multipod.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Any

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES
from repro_torch.kernels._build import BUILD
from repro_torch.launch import step_builders as sb
from repro_torch.launch.mesh import (MULTI_POD, POD, fake_world, mesh_axes,
                                     mesh_name)
from repro_torch.parallel import sharding as shd
from repro_torch.utils import roofline
from repro_torch.utils.cost import CostCounter, collective_report

__all__ = ["run_cell", "count_step", "main", "OPTIMIZED_FLAGS",
           "EXTRA_CELLS"]

OPTIMIZED_FLAGS = {
    # the reference's hillclimb-validated flags (`repro/launch/dryrun.py`)
    "train": {"bf16_flow": True, "flash_remat": True},     # + per-arch mb
    "prefill": {"bf16_flow": True},
    "decode": {"moe_dispatch": "resident", "bf16_flow": True},
}

# read only under a mesh (the reference's flash_attention and MoE
# shard_map paths): the port's MoE reads moe_dispatch in its mesh body,
# so it counts in a mesh row and changes nothing in one card's; the port
# has no flash_remat (its flash backward recomputes the scores in any
# case), so that flag changes neither
MESH_ONLY = ("flash_remat", "moe_dispatch")

# cells beyond the reference's grid: (arch, shape, overrides)
EXTRA_CELLS = [("qwen1.5-4b", "prefill_32k", {"use_sparse_ffn": True}),
               ("qwen1.5-4b", "decode_32k", {"use_sparse_ffn": True})]

DEFAULT_OUT = BUILD / "dryrun.json"


def _hw(device: torch.device) -> roofline.HW:
    """The card's row: the card's own on CUDA, the H100's datasheet row
    on meta."""
    if device.type == "cuda":
        return roofline.card_hw()
    return roofline.card("H100")


def _notes(overrides: dict, device: torch.device, mesh: str | None,
           rank: int) -> str:
    notes = []
    if device.type == "meta":
        notes.append("counted on meta: predicted for the datasheet row")
    if mesh is None:
        mesh_only = [k for k in MESH_ONLY if k in overrides]
        if mesh_only:
            notes.append(f"{', '.join(mesh_only)}: read only under a mesh, "
                         f"not on one card")
    else:
        notes.append(f"rank {rank} of {mesh}: per device; "
                     f"{roofline.LINK_NOTE}")
        if "flash_remat" in overrides:
            notes.append("flash_remat: no counterpart in the port (its "
                         "flash backward recomputes the scores)")
    return "; ".join(notes)


def count_step(cfg, shape, dev: torch.device, mesh: str | None = None,
               rank: int = 0) -> tuple[Any, dict | None]:
    """(the step's `utils.cost.StepCost`, the mesh's {dim: size} or
    None): one card's step, or rank ``rank``'s under the mesh named
    ``mesh`` in a fake world."""
    if mesh is None:
        step = sb.build(cfg, shape, dev)
        with CostCounter(step.args, dev) as counter:
            step.fn(*step.args)
        return counter.cost, None
    with fake_world(mesh, rank) as dm:
        ctx = shd.MeshContext(dm, shd.TRAIN_RULES)
        step = sb.build(cfg, shape, dev, ctx=ctx)
        with CostCounter(step.args, dev, mesh=dm) as counter:
            step.fn(*step.args)
        return counter.cost, shd.mesh_shape(dm)


def run_cell(arch: str, shape_name: str, *, device: str = "meta",
             verbose: bool = True, overrides: dict | None = None,
             tag: str = "", cfg: Any = None, shape: Any = None,
             mesh: str | None = None, rank: int = 0) -> dict:
    """One cell's row: ``status`` "ok" with the roofline row (the
    reference's keys, ``fits``, ``trace_s``, the kernels' launches and
    the count of ops), or "skip" with the reason.  ``cfg`` and
    ``shape`` default to ``arch``'s registered config and
    ``SHAPES[shape_name]`` (a test passes reduced ones).

    ``mesh`` (`launch.mesh.mesh_axes`: `POD` "16x16", `MULTI_POD`
    "2x16x16", or a small one such as "2x2") counts rank ``rank``'s step
    of that mesh on meta: FLOPs, bytes, wire bytes, ``arg_gb``,
    ``temp_gb`` and ``fits`` per device, ``chips`` the mesh's size, and
    beside the reference's keys ``rank``, ``coll_by_dim`` and ``links``
    (each dim's link rate, GB/s each way).  Without it, one card's whole
    step (the mesh named after the card, ``chips`` 1)."""
    cfg = get_config(arch) if cfg is None else cfg
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name] if shape is None else shape
    dev = torch.device(device)
    hw = _hw(dev)
    if mesh is None:
        name = skip_name = f"{hw.name.replace(' ', '-')}x1"
    else:
        if dev.type != "meta":
            raise ValueError("a mesh's rank is counted on meta only")
        name = mesh_name(shd.AbstractMesh(*mesh_axes(mesh)))
        skip_name = "pod" + mesh.lower()
    reason = cfg.supported_shapes()[shape_name]
    if not reason and shape.kind == "train" and cfg.use_sparse_ffn:
        reason = ("vector-sparse FFN: no training step (its tree holds "
                  "int32 K-tile ids, which the reference's value_and_grad "
                  "refuses)")
    if reason:
        if verbose:
            print(f"SKIP  {arch} x {shape_name}: {reason}")
        return {"arch": arch, "shape": shape_name, "mesh": skip_name,
                "status": "skip", "reason": reason}

    t0 = time.perf_counter()
    cost, sizes = count_step(cfg, shape, dev, mesh, rank)
    trace_s = time.perf_counter() - t0
    rep = roofline.report(
        arch=arch, shape=shape_name, mesh_name=name,
        chips=1 if sizes is None else math.prod(sizes.values()), cost=cost,
        model_flops=sb.model_flops(cfg, shape), mem_stats=cost, hw=hw,
        notes=_notes(overrides or {}, dev, mesh, rank), mesh_shape=sizes)
    row = rep.row()
    row.update(status="ok", trace_s=round(trace_s, 1), tag=tag,
               overrides={k: str(v) for k, v in (overrides or {}).items()},
               kernels=dict(cost.kernels),
               ops=sum(n for n, _, _ in cost.ops.values()))
    if sizes is not None:
        row.update(rank=rank, coll_by_dim=dict(cost.coll_by_dim),
                   links={k: v / 1e9 for k, v in
                          roofline.dim_links(sizes, hw).items()})
    if verbose:
        print(rep.summary())
        print(f"  traced {trace_s:.1f}s on {dev.type} | {row['ops']} ops"
              f" | kernels {row['kernels']}")
        if sizes is not None:
            print("  " + collective_report(cost).replace("\n", "\n  "))
    return row


def _cells() -> list[tuple[str, str, dict]]:
    return [(a, s, {}) for a in list_archs() for s in SHAPES] + EXTRA_CELLS


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help=f"count one rank of this mesh ({POD}, "
                         f"{MULTI_POD}, or DxM / PxDxM); default: one card")
    ap.add_argument("--multipod", action="store_true",
                    help=f"--mesh {MULTI_POD}; writes *_multipod.json")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh counted")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the hillclimb-validated beyond-paper flags")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    mesh = args.mesh
    if args.multipod:
        if mesh not in (None, MULTI_POD):
            print(f"dryrun: --multipod is --mesh {MULTI_POD}, not {mesh}",
                  file=sys.stderr)
            return 2
        mesh = MULTI_POD

    if args.all:
        cells = _cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, {})]
    else:
        ap.error("--arch/--shape or --all")

    rows = []
    for arch, shape, extra in cells:
        print(f"=== {arch} x {shape} ({mesh or 'one card'}) ===", flush=True)
        kind = SHAPES[shape].kind
        if args.optimized:
            overrides = dict(OPTIMIZED_FLAGS[kind])
            if kind != "train":
                overrides.pop("flash_remat", None)
        else:
            # baseline semantics: no microbatching (configs carry tuned
            # defaults for the optimized sweep)
            overrides = {"microbatches": 1}
        overrides.update(extra)
        try:
            rows.append(run_cell(arch, shape, overrides=overrides,
                                 tag="optimized" if args.optimized
                                 else "baseline", mesh=mesh,
                                 rank=args.rank))
        # vscheck: ignore[VSC304] — sweep driver, not a serving fault path
        except Exception as e:  # a failing cell is a bug; record and go on
            traceback.print_exc()
            rows.append({"arch": arch, "shape": shape, "status": "error",
                         "error": f"{type(e).__name__}: {e}"})
    out = args.out.replace(".json", "_multipod.json") if args.multipod \
        else args.out
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    roofline.save_rows(out, rows)
    ok = sum(r.get("status") == "ok" for r in rows)
    skip = sum(r.get("status") == "skip" for r in rows)
    err = sum(r.get("status") == "error" for r in rows)
    print(f"\n{ok} ok / {skip} skip / {err} error -> {out}")
    return 1 if err else 0


if __name__ == "__main__":
    raise SystemExit(main())
