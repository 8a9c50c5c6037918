"""Dry run: count every (arch x shape) step on the meta device and write
its roofline row.

The port of `repro/launch/dryrun.py`.  Per cell the reference builds the
step, lowers and compiles it without allocating anything, prints its
``memory_analysis()`` (the proof that the cell fits) and turns the
compiled HLO into FLOPs, bytes and wire bytes (`repro/utils/hlo.py`).
The port has no XLA program; per cell it

  1. builds the step on empty ``meta`` tensors (`step_builders.build`),
  2. runs it once under `utils.cost.CostCounter`: every op the card would
     run, the hand-written kernels as one op each, with nothing
     allocated and nothing launched,
  3. reports the arguments' and the peak temporaries' bytes and whether
     they fit in the card's memory (``fits``),
  4. writes the roofline row (`utils.roofline.report`) against the
     card's datasheet row (`utils.roofline.HW`): predictions for that
     card, not measurements.

``chip_smoke.py``'s ``dryrun`` phase holds the meta count against the
count of the same steps run on the card.  The grid is the reference's:
every registered LM arch at every pod shape of `configs.base.SHAPES`
(``train_4k`` is 256 x 4096 tokens), so most cells do not fit one card,
which is the answer the dry run exists to give; unsupported shapes are
skipped with `supported_shapes`'s reason.  One cell beyond the
reference's: Qwen1.5-4B with the vector-sparse FFN at ``prefill_32k`` and
``decode_32k``, the paper's skip in the roofline (the sparse FFN does not
train, as in the reference).

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--optimized] [--out rows.json]
"""
from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.utils import roofline
from repro_torch.utils.cost import CostCounter

__all__ = ["run_cell", "main", "OPTIMIZED_FLAGS", "EXTRA_CELLS"]

OPTIMIZED_FLAGS = {
    # the reference's hillclimb-validated flags (`repro/launch/dryrun.py`)
    "train": {"bf16_flow": True, "flash_remat": True},     # + per-arch mb
    "prefill": {"bf16_flow": True},
    "decode": {"moe_dispatch": "resident", "bf16_flow": True},
}

# read only under a mesh (the reference's flash_attention and MoE
# shard_map paths; the port's MoE reads moe_dispatch in its mesh body,
# and has no flash_remat: its flash backward recomputes the scores in
# any case).  The port trains and serves under a mesh, but the dry run
# counts one card's whole step with no mesh, so they change nothing here
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


def _notes(overrides: dict, device: torch.device) -> str:
    notes = []
    if device.type == "meta":
        notes.append("counted on meta: predicted for the datasheet row")
    mesh_only = [k for k in MESH_ONLY if k in overrides]
    if mesh_only:
        notes.append(f"{', '.join(mesh_only)}: read only under a mesh, "
                     f"not on one card")
    return "; ".join(notes)


def run_cell(arch: str, shape_name: str, *, device: str = "meta",
             verbose: bool = True, overrides: dict | None = None,
             tag: str = "", cfg: Any = None, shape: Any = None) -> dict:
    """One cell's row: ``status`` "ok" with the roofline row (the
    reference's keys, ``fits``, ``trace_s``, the kernels' launches and
    the count of ops), or "skip" with the reason.  ``cfg`` and
    ``shape`` default to ``arch``'s registered config and
    ``SHAPES[shape_name]`` (a test passes reduced ones)."""
    cfg = get_config(arch) if cfg is None else cfg
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name] if shape is None else shape
    dev = torch.device(device)
    hw = _hw(dev)
    mesh = f"{hw.name.replace(' ', '-')}x1"
    reason = cfg.supported_shapes()[shape_name]
    if not reason and shape.kind == "train" and cfg.use_sparse_ffn:
        reason = ("vector-sparse FFN: no training step (its tree holds "
                  "int32 K-tile ids, which the reference's value_and_grad "
                  "refuses)")
    if reason:
        if verbose:
            print(f"SKIP  {arch} x {shape_name}: {reason}")
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "status": "skip", "reason": reason}

    t0 = time.perf_counter()
    step = sb.build(cfg, shape, dev)
    with CostCounter(step.args, dev) as counter:
        step.fn(*step.args)
    trace_s = time.perf_counter() - t0
    cost = counter.cost
    rep = roofline.report(
        arch=arch, shape=shape_name, mesh_name=mesh, chips=1, cost=cost,
        model_flops=sb.model_flops(cfg, shape), mem_stats=cost, hw=hw,
        notes=_notes(overrides or {}, dev))
    row = rep.row()
    row.update(status="ok", trace_s=round(trace_s, 1), tag=tag,
               overrides={k: str(v) for k, v in (overrides or {}).items()},
               kernels=dict(cost.kernels),
               ops=sum(n for n, _, _ in cost.ops.values()))
    if verbose:
        print(rep.summary())
        print(f"  traced {trace_s:.1f}s on {dev.type} | {row['ops']} ops"
              f" | kernels {row['kernels']}")
    return row


def _cells() -> list[tuple[str, str, dict]]:
    return [(a, s, {}) for a in list_archs() for s in SHAPES] + EXTRA_CELLS


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the hillclimb-validated beyond-paper flags")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    if args.multipod:
        print("dryrun: --multipod needs a mesh of pods; the port runs on "
              "one card", file=sys.stderr)
        return 2

    if args.all:
        cells = _cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, {})]
    else:
        ap.error("--arch/--shape or --all")

    rows = []
    for arch, shape, extra in cells:
        print(f"=== {arch} x {shape} (one card) ===", flush=True)
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
                                 else "baseline"))
        # vscheck: ignore[VSC304] — sweep driver, not a serving fault path
        except Exception as e:  # a failing cell is a bug; record and go on
            traceback.print_exc()
            rows.append({"arch": arch, "shape": shape, "status": "error",
                         "error": f"{type(e).__name__}: {e}"})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    roofline.save_rows(args.out, rows)
    ok = sum(r.get("status") == "ok" for r in rows)
    skip = sum(r.get("status") == "skip" for r in rows)
    err = sum(r.get("status") == "error" for r in rows)
    print(f"\n{ok} ok / {skip} skip / {err} error -> {args.out}")
    return 1 if err else 0


if __name__ == "__main__":
    raise SystemExit(main())
