#!/usr/bin/env python3
"""Warm CNN serve time of two checkouts of the port, in turns, on one card.

Run from anywhere on a machine with an NVIDIA GPU:

    python3 serve_ab.py BEFORE_DIR AFTER_DIR [--pairs 5]

Each run is a fresh process with ``<dir>/src`` on its path: it builds the
kernels it needs, then serves 16 seeded 224x224 requests at batch 8
through the halo path (``impl="auto"``) of ResNet-18 and MobileNetV1, six
times each, and reports the median warm ms per wave (the first serve is
cold and dropped).  Runs alternate before, after, after, before, ...  It
prints one JSON line per run, then per side and net the median over runs
and the quartiles.  Exit code 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

NETS = ("vscnn-resnet18", "vscnn-mobilenet-v1")


def one_side(root: str) -> dict:
    """Median warm ms per wave of each net, served from ``root``."""
    sys.path.insert(0, f"{root}/src")
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CNNServer, ImageRequest

    dev = torch.device("cuda")
    out = {}
    for name in NETS:
        srv = CNNServer(get_config(name), batch=8, impl="auto", seed=0,
                        device=dev)
        rng = np.random.default_rng(0)
        images = [rng.standard_normal((224, 224, 3)).astype(np.float32)
                  for _ in range(16)]
        waves = []
        for rep in range(6):
            reqs = [ImageRequest(rid=i, image=im)
                    for i, im in enumerate(images)]
            torch.cuda.synchronize()
            stats = srv.serve(reqs)
            torch.cuda.synchronize()
            if rep:
                waves.append(1e3 * sum(s["run_s"] for s in stats)
                             / sum(s["steps"] for s in stats))
        out[name] = statistics.median(waves)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--side", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.side is not None:
        print(json.dumps(one_side(args.side)))
        return 0
    order = [(args.before, args.after), (args.after, args.before)]
    runs = {"before": [], "after": []}
    for i in range(args.pairs):
        for root in order[i % 2]:
            side = "before" if root == args.before else "after"
            res = subprocess.run(
                [sys.executable, __file__, args.before, args.after,
                 "--side", root], check=True, capture_output=True,
                text=True).stdout.strip().splitlines()[-1]
            runs[side].append(json.loads(res))
            print(json.dumps({"side": side, "root": root,
                              "ms_per_wave": runs[side][-1]}), flush=True)
    summary = {}
    for side, rs in runs.items():
        for name in NETS:
            v = sorted(r[name] for r in rs)
            q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
            summary[f"{side} {name}"] = {"median": statistics.median(v),
                                         "q1": q[0], "q3": q[2],
                                         "runs": [r[name] for r in rs]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
