#!/usr/bin/env python3
"""The one-time knee sweep of an open-loop mix: a configuration of
``BENCHMARK.json`` under the mix ``traffic/<name>.json`` at a few fixed
rates, one short window each, after one set-up.

    python3 portbench/sweep.py --config resnet50-vs235-f32 \\
        --traffic server-resnet50 --seed 7 --seconds 8 \\
        --rates 1500,2000,2500,3000

For each rate it prints the images delivered a second inside the window,
the backlog at its close (requests due before the close and not yet
served then), and the p50 and p95 latency of the window's requests.  The
highest rate whose backlog stays small (under one wave) is the knee; a
cell's ``rate_per_s`` is 0.8 of it.
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
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness.manifest import BENCH_DIR, cell_of

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    manifest = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    cell = cell_of(manifest, {"name": f"{args.config}.{args.traffic}",
                              "config": args.config,
                              "traffic": args.traffic, "chips": 1})
    bench = bench_run.Bench(cell, args.seed % 2**63, "cuda")
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(cell.traffic, rate_per_s=rate)
        session, out = bench.window(args.seconds, False, traffic)
        r = session.arrays()
        s = args.seconds
        lat = (r["end"] - r["due"])[r["ok"]] * 1e3
        row = {"workload": cell.name, "rate_per_s": rate,
               "arrivals": out["attempted"],
               "delivered_per_s": float((r["end"] <= s).sum()) / s,
               "backlog_at_close": int(((r["due"] < s)
                                        & (r["end"] > s)).sum()),
               "latency_p50_ms": float(np.percentile(lat, 50)),
               "latency_p95_ms": float(np.percentile(lat, 95)),
               "waves": len(session.calls),
               "mean_wave_rows": float(np.mean([sum(c.rows)
                                                for c in session.calls])),
               "card": bench_run.power_limit()}
        print(json.dumps(row), flush=True)
    bench.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
