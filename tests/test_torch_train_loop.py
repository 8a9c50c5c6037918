"""The port's `TrainLoop` and its CLI, on the CPU.

The assertions of the reference's `test_system.py::TestTrainLoop` (which
fails on this JAX under its mesh): 8 finite steps of reduced Qwen1.5-4B
with a loss spread under 1.0 (fresh batches and the lr warmup: stability,
not descent), a resume at step 8 from the checkpoint, then exactly 2 more
steps; the straggler monitor; a MoE arch trains.  A resumed run equals an
uninterrupted one (the pipeline skips to the step, the state is restored
bit for bit), and the CLI runs with ``--device cpu``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import StragglerMonitor, TrainLoop, main
from repro_torch.utils.tree import leaves

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


class TestTrainLoop:
    def test_loss_is_stable_and_resumes(self, tmp_path):
        cfg = get_config("qwen1.5-4b").reduce()
        ck = str(tmp_path / "ckpt")
        loop = TrainLoop(cfg, batch=4, seq=32, ckpt_dir=ck, ckpt_every=5,
                         device="cpu")
        _, _, hist = loop.run(8, log_every=100)
        assert len(hist) == 8 and all(np.isfinite(hist))
        assert max(hist) - min(hist) < 1.0
        loop2 = TrainLoop(cfg, batch=4, seq=32, ckpt_dir=ck, ckpt_every=5,
                          device="cpu")
        _, _, start = loop2.maybe_resume()
        assert start == 8
        _, _, hist2 = loop2.run(10, log_every=100)
        assert len(hist2) == 2  # steps 8..9 only
        assert sorted(os.listdir(ck)) == ["step_10", "step_5", "step_8"]

    def test_resume_equals_an_uninterrupted_run(self, tmp_path):
        cfg = get_config("qwen1.5-4b").reduce()
        whole = TrainLoop(cfg, batch=2, seq=32, ckpt_dir=None, device="cpu")
        p_whole, s_whole, h_whole = whole.run(5, log_every=100)
        ck = str(tmp_path / "ckpt")
        TrainLoop(cfg, batch=2, seq=32, ckpt_dir=ck,
                  device="cpu").run(4, log_every=100)
        resumed = TrainLoop(cfg, batch=2, seq=32, ckpt_dir=ck, device="cpu")
        p_res, s_res, h_res = resumed.run(5, log_every=100)
        assert h_res == h_whole[4:]
        for a, b in zip(leaves(p_res) + leaves(s_res),
                        leaves(p_whole) + leaves(s_whole)):
            assert torch.equal(a, b)

    def test_straggler_monitor(self):
        mon = StragglerMonitor(window=8, factor=3.0)
        for _ in range(10):
            assert not mon.observe(0.1)
        assert mon.observe(1.0)
        assert mon.events == 1

    def test_moe_arch_trains(self, tmp_path):
        cfg = get_config("granite-moe-3b-a800m").reduce()
        beat = tmp_path / "beat.json"
        loop = TrainLoop(cfg, batch=4, seq=32, ckpt_dir=None, device="cpu")
        _, _, hist = loop.run(4, log_every=100, heartbeat=str(beat))
        assert all(np.isfinite(hist))
        assert max(hist) - min(hist) < 1.0
        assert json.loads(beat.read_text())["step"] == 3

    def test_embedding_input_arch_trains(self):
        cfg = get_config("hubert-xlarge").reduce()
        loop = TrainLoop(cfg, batch=2, seq=32, ckpt_dir=None, device="cpu")
        assert set(loop.batch_at(0)) == {"embeds", "labels"}
        _, _, hist = loop.run(2, log_every=100)
        assert all(np.isfinite(hist))


def test_main_in_process(capsys):
    main(["--arch", "rwkv6-3b", "--smoke", "--steps", "3", "--batch", "2",
          "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "final loss" in out


def test_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-4b", "--smoke", "--steps", "20", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "step    19 loss" in proc.stdout
    assert "final loss" in proc.stdout
