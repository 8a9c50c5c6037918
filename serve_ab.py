#!/usr/bin/env python3
"""Warm serve times of two checkouts of the port, in turns, on one card.

Run from anywhere on a machine with an NVIDIA GPU:

    python3 serve_ab.py BEFORE_DIR AFTER_DIR [--pairs 5] [--lm | --train]

Each run is a fresh process with ``<dir>/src`` on its path: it builds the
kernels it needs, then serves 16 seeded 224x224 requests at batch 8
through the halo path (``impl="auto"``) of ResNet-18, MobileNetV1 and
VGG-16 in f32 and of ResNet-18 and MobileNetV1 in int8
(``dtype="int8"``), six times each, and reports the median warm ms per
wave (the first serve is cold and dropped).  With ``--lm`` it also serves
Qwen1.5-4B (bf16 weights from seed 0) at batch 8 and capacity 552: it
admits 8 seeded prompts of 512 tokens, takes 2 decode steps untimed, then
reports the ms per decode step over the next 16 (`LMBackend.step`:
forward, sampling and the tokens' copy to the host; CUDA-synchronized
wall clock).  With ``--train`` it times, in place of the CNN paths,
Qwen1.5-4B's eager prefill (8 seeded prompts of 512 tokens into capacity
552: 1 untimed, the mean of the next 3) and its training step
(`build_train` with its config: 8 x 512 tokens in 4 microbatches,
AdamW, remat; steps 200-201 untimed, the mean of 202-204).  Runs
alternate before, after, after, before, ...  It
prints one JSON line per run, then per side and path the median over
runs and the quartiles.  Exit code 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# path -> (config, dtype)
PATHS = {
    "resnet18-halo": ("vscnn-resnet18", None),
    "mobilenet_v1-halo": ("vscnn-mobilenet-v1", None),
    "vgg16-halo": ("vscnn-vgg16", None),
    "resnet18-int8-halo": ("vscnn-resnet18", "int8"),
    "mobilenet_v1-int8-halo": ("vscnn-mobilenet-v1", "int8"),
}
LM_PATH = "qwen1.5-4b-decode"
TRAIN_PATHS = ("qwen1.5-4b-prefill", "qwen1.5-4b-train-step")


def _cnn_ms_per_wave(name: str, dtype: str | None, dev) -> float:
    """Median warm ms per wave of one CNN path."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CNNServer, ImageRequest

    srv = CNNServer(get_config(name), batch=8, impl="auto", dtype=dtype,
                    seed=0, device=dev)
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((224, 224, 3)).astype(np.float32)
              for _ in range(16)]
    waves = []
    for rep in range(6):
        reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]
        torch.cuda.synchronize()
        stats = srv.serve(reqs)
        torch.cuda.synchronize()
        if rep:
            waves.append(1e3 * sum(s["run_s"] for s in stats)
                         / sum(s["steps"] for s in stats))
    return statistics.median(waves)


def _lm_ms_per_step(dev) -> float:
    """Warm ms per decode step of Qwen1.5-4B at batch 8."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, Server

    cfg = get_config("qwen1.5-4b")
    srv = Server(cfg, batch=8, capacity=552, seed=0, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 512),
                    max_new=32) for i in range(8)]
    be = srv.backend
    state, _ = be.start(reqs, 8)
    for _ in range(2):
        state, _ = be.step(state, reqs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        state, _ = be.step(state, reqs)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / 16


def _mean_ms(fn, warm: int, timed: int) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / timed


def _train_ms(dev) -> dict:
    """Qwen1.5-4B's warm eager prefill and training step, in ms."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import step_builders as sb
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import init_params

    cfg = get_config("qwen1.5-4b")
    params = init_params(tfm.lm_schema(cfg), 0, dtype=cfg.dtype, device=dev,
                         draw_on_device=True)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 512))).to(dev)
    out = {TRAIN_PATHS[0]: _mean_ms(
        lambda: tfm.prefill(params, {"tokens": toks}, cfg, capacity=552),
        1, 3)}
    torch.cuda.empty_cache()
    step_fn = sb.build_train(cfg, ShapeSpec("train", 512, 8, "train"))
    opt_state = sb.make_optimizer(cfg).init(params)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 512)))
             .int().to(dev) for k in ("tokens", "labels")}
    step = [200]

    def train():
        step_fn(params, opt_state, batch, step[0])
        step[0] += 1

    out[TRAIN_PATHS[1]] = _mean_ms(train, 2, 3)
    return out


def one_side(root: str, lm: bool, train: bool) -> dict:
    """Each path's warm time, served from ``root``."""
    sys.path.insert(0, f"{root}/src")
    import torch

    dev = torch.device("cuda")
    if train:
        return _train_ms(dev)
    out = {}
    for path, (name, dtype) in PATHS.items():
        out[path] = _cnn_ms_per_wave(name, dtype, dev)
        torch.cuda.empty_cache()
    if lm:
        out[LM_PATH] = _lm_ms_per_step(dev)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--lm", action="store_true",
                    help="also time the Qwen1.5-4B decode step at batch 8")
    ap.add_argument("--train", action="store_true",
                    help="time Qwen1.5-4B's eager prefill and training "
                         "step instead of the CNN paths")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.side is not None:
        print(json.dumps(one_side(args.side, args.lm, args.train)))
        return 0
    order = [(args.before, args.after), (args.after, args.before)]
    runs = {"before": [], "after": []}
    for i in range(args.pairs):
        for root in order[i % 2]:
            side = "before" if root == args.before else "after"
            res = subprocess.run(
                [sys.executable, __file__, args.before, args.after,
                 "--side", root] + (["--lm"] if args.lm else [])
                + (["--train"] if args.train else []),
                check=True, capture_output=True,
                text=True).stdout.strip().splitlines()[-1]
            runs[side].append(json.loads(res))
            print(json.dumps({"side": side, "root": root,
                              "ms": runs[side][-1]}), flush=True)
    summary = {}
    for side, rs in runs.items():
        for path in rs[0]:
            v = sorted(r[path] for r in rs)
            q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
            summary[f"{side} {path}"] = {"median": statistics.median(v),
                                         "q1": q[0], "q3": q[2],
                                         "runs": [r[path] for r in rs]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
