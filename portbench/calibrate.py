#!/usr/bin/env python3
"""The readings that the limit of ``logit_rel_err`` is set from.

    python3 portbench/calibrate.py --workload resnet50.offline \\
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 3

For each seed, one process sets the cell up, runs its traffic for a
short window at the cell's own load and sizes, and compares the seeded
sample of delivered logits with the f32 reference: the program's reading.
For each control seed it also computes the reference in TF32 (matmuls
and cuDNN convolutions; the nearest precision below the configuration's
f32) on the same sample: the control's reading.  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as bench_run  # noqa: E402  (portbench/run.py: paths, Bench)

import numpy as np  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness.check import logit_rel_err
    from portbench.harness.manifest import load_cell

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        bench = bench_run.Bench(cell, seed % 2**63, "cuda")
        session, out = bench.window(args.seconds, False)
        sample = session.sampler.items()
        served = np.stack([y for _, y in sample])
        del session
        bench.close()
        flags = (False, True) if seed in controls else (False,)
        refs = bench.reference(sample, tf32=flags)
        row = {"workload": args.workload, "seed": seed,
               "sampled": len(sample), "attempted": out["attempted"],
               "program": logit_rel_err(served, refs[0])}
        if len(refs) > 1:
            row["control_tf32"] = logit_rel_err(refs[1], refs[0])
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": bench_run.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
