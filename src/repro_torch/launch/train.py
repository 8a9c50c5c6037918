"""Fault-tolerant training loop, on one device or under a mesh.

The port of `repro/launch/train.py`: `TrainLoop` drives
`step_builders.build_train` over the synthetic data pipeline with

  * auto-resume: a restart picks up the latest complete checkpoint, and
    the data pipeline skips to the right step deterministically,
  * atomic async checkpoints (`checkpoint.CheckpointManager`, the
    reference's on-disk format) every ``ckpt_every`` steps and at the end,
  * straggler detection: each step's wall time against a rolling median,
    slow steps logged and counted (simulated on the host),
  * a heartbeat file for external watchdogs.

With ``mesh=`` (a ``("data", "model")`` `DeviceMesh` over a
`torch.distributed` world, `launch.mesh`) every rank runs the loop
(SPMD): params and optimizer state are DTensors laid out by the
``rules`` (`parallel.sharding.TRAIN_RULES`), every rank builds the
*global* batch from the seed and keeps its rows of it (the reference's
``n_shards=1``), checkpoints gather each leaf to rank 0, which writes
them, and restore lays a checkpoint out on whatever mesh (or none) the
loop has.  Rank 0 logs and writes the heartbeat.  ``mesh=None`` is the
one-device loop.

Usage (reduced config on the CPU; drop ``--device cpu`` for the card):
  python -m repro_torch.launch.train --arch qwen1.5-4b --smoke --steps 50 \\
      --device cpu
and on four CPU ranks, a 2x2 mesh (one process a rank)::
  for r in 0 1 2 3; do RANK=$r WORLD_SIZE=4 python -m \\
      repro_torch.launch.train --arch qwen1.5-4b --smoke --steps 4 \\
      --device cpu --dist-store /tmp/store --mesh 2x2 & done; wait

It runs on the card unless ``--device cpu`` is given; with no card it
raises (`core.device.resolve_device`), it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import atexit
import json
import statistics
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import LMBatchSpec, SyntheticEmbeds, SyntheticLM
from repro_torch.launch import step_builders as sb
from repro_torch.launch.mesh import init_process_group, make_local_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_params
from repro_torch.parallel import sharding as shd

__all__ = ["StragglerMonitor", "TrainLoop", "main"]


class StragglerMonitor:
    """Rolling-median step-time watchdog (simulated straggler mitigation)."""

    def __init__(self, window: int = 32, factor: float = 3.0):
        self.times: list[float] = []
        self.window = window
        self.factor = factor
        self.events = 0

    def observe(self, dt: float) -> bool:
        slow = False
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            if dt > self.factor * med:
                self.events += 1
                slow = True
        self.times.append(dt)
        return slow


class TrainLoop:
    def __init__(self, cfg, *, batch: int, seq: int, ckpt_dir: str | None,
                 ckpt_every: int = 50, seed: int = 0,
                 device: str | torch.device | None = None, mesh=None,
                 rules: shd.MeshRules | None = None):
        self.cfg = cfg
        self.batch, self.seq = batch, seq
        self.device = resolve_device(device)
        self.seed = seed
        self.mesh = mesh
        self.ctx = (None if mesh is None else
                    shd.MeshContext(mesh, rules or shd.TRAIN_RULES))
        self.ckpt = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        spec = LMBatchSpec(global_batch=batch, seq_len=seq, vocab=cfg.vocab,
                           n_shards=1, shard=0)
        if cfg.embed_inputs:
            self.data = SyntheticLM(spec, seed=seed)
        else:
            self.data = SyntheticEmbeds(spec, cfg.d_model, seed=seed)
        self.opt = sb.make_optimizer(cfg)
        self.monitor = StragglerMonitor()
        self.step_fn = sb.build_train(
            cfg, ShapeSpec("custom", seq, batch, "train"), self.ctx)
        self.lead = self.ctx is None or dist.get_rank() == 0

    def init_state(self, seed: int = 0) -> tuple[Any, Any, int]:
        """(params, opt_state, 0): the port's seeded init (drawn on the
        card when it runs there) and a fresh optimizer state; under a
        mesh every rank draws the same tree and keeps its shards."""
        cfg = self.cfg
        params = init_params(tfm.lm_schema(cfg), seed, dtype=cfg.dtype,
                             device=self.device, draw_on_device=True)
        if self.ctx is not None:
            with shd.use_mesh(self.ctx.mesh, self.ctx.rules):
                params = tfm.shard_params(params, cfg)
        return params, sb.init_opt_state(cfg, params, self.ctx), 0

    def maybe_resume(self) -> tuple[Any, Any, int]:
        """Returns (params, opt_state, start_step); resumes if possible,
        each leaf laid out as the fresh state's (elastic: any mesh)."""
        params, opt_state, step = self.init_state()
        if self.ckpt and self.ckpt.latest_step() is not None:
            tree, ck_step, _ = self.ckpt.restore(
                {"params": params, "opt": opt_state})
            if self.lead:
                print(f"[train] resumed from checkpoint step {ck_step}")
            return tree["params"], tree["opt"], ck_step
        return params, opt_state, step

    def batch_at(self, step: int) -> dict:
        """The pipeline's batch of ``step`` as tensors on the device (the
        global batch; under a mesh, DTensors of each rank's rows)."""
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.data.batch_at(step).items()}
        if self.ctx is None:
            return batch
        return sb.shard_batch(self.cfg, batch, self.ctx)

    def run(self, steps: int, *, log_every: int = 10,
            heartbeat: str | None = None) -> tuple[Any, Any, list]:
        params, opt_state, start = self.maybe_resume()
        history = []
        say = print if self.lead else (lambda *a, **k: None)
        for step in range(start, steps):
            t0 = time.time()
            params, opt_state, metrics = self.step_fn(
                params, opt_state, self.batch_at(step), step)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if self.monitor.observe(dt):
                say(f"[straggler] step {step} took {dt:.2f}s (median "
                    f"{statistics.median(self.monitor.times[-32:]):.2f}s)")
            if heartbeat and self.lead:
                with open(heartbeat, "w") as f:
                    json.dump({"step": step, "t": time.time(),
                               "loss": loss}, f)
            history.append(loss)
            if step % log_every == 0 or step == steps - 1:
                tok_s = self.batch * self.seq / dt
                say(f"step {step:5d} loss {loss:8.4f} "
                    f"grad_norm {float(metrics['grad_norm']):7.3f} "
                    f"{dt*1e3:7.1f} ms/step {tok_s:9.0f} tok/s")
            if self.ckpt and step and step % self.ckpt_every == 0:
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               metadata={"loss": loss})
        if self.ckpt:
            self.ckpt.save(steps, {"params": params, "opt": opt_state},
                           block=True)
        return params, opt_state, history


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path; the card by default")
    ap.add_argument("--dist-store", default=None,
                    help="join a torch.distributed world (RANK, WORLD_SIZE "
                         "from the environment) through this file:// store "
                         "path; every rank trains and rank 0 prints")
    ap.add_argument("--mesh", default=None,
                    help="train under a DATAxMODEL mesh over the world "
                         "(needs --dist-store)")
    args = ap.parse_args(argv)
    if args.mesh and not args.dist_store:
        ap.error("--mesh needs --dist-store")
    device = args.device
    if args.dist_store:
        device = init_process_group(args.dist_store, device=args.device)
        atexit.register(dist.destroy_process_group)
    mesh = None
    if args.mesh:
        data, model = (int(v) for v in args.mesh.lower().split("x"))
        mesh = make_local_mesh(data, model)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduce()
    loop = TrainLoop(cfg, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     seed=args.seed, device=device, mesh=mesh)
    _, _, history = loop.run(args.steps, heartbeat=args.heartbeat)
    if loop.lead:
        print(f"final loss {history[-1]:.4f} (from {history[0]:.4f}); "
              f"straggler events: {loop.monitor.events}")


if __name__ == "__main__":
    main()
