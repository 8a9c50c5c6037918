"""Whole runs on the CPU at reduced sizes: the last line's shape, the
exit without a card, and the check that decides ``correct``."""
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench.harness.manifest import load_cell
from portbench.tests.conftest import ROOT, add_cell, load_run

SEED = 2**31 + 12345


def _run(root, cell, seed=SEED, seconds=1.0, trace=False):
    run = load_run()
    c = load_cell(cell, bench_dir=root / "portbench")
    return run, run.run(c, seed, seconds, trace, "cpu")


@pytest.mark.parametrize("cell", ["resnet50.offline", "vgg16.server"])
def test_last_line_shape(reduced_copy, cell):
    if cell == "vgg16.server":      # the open loop, in a cell of its own
        add_cell(reduced_copy, cell, "vgg16-vs235-f32", "server-vgg16",
                 ("latency_p95_ms", "latency_p50_ms"))
    run, result = _run(reduced_copy, cell)
    line = run.result_line(result)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    manifest = json.loads((reduced_copy / "BENCHMARK.json").read_text())
    want = {m["name"] for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_no_card_exits_nonzero_and_prints_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "resnet50.offline", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_program_exits_nonzero(tmp_path, reduced_copy):
    # a directory with BENCHMARK.json and portbench/ only: no src/
    run = load_run()
    c = load_cell("resnet50.offline", bench_dir=reduced_copy / "portbench")
    code = ("import sys; sys.path[:] = [p for p in sys.path if 'src' not in p]"
            "; import repro_torch")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=60,
                       env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert c.config["arch"]   # the cell itself resolves without the program


def _break(monkeypatch, fault):
    """Break the timed path underneath the harness."""
    from repro_torch.launch import serve
    from repro_torch.models import graph

    if fault == "answer_altered":
        orig = serve.CNNBackend.collect

        def collect(self, state, handle, slots):
            state, emis = orig(self, state, handle, slots)
            for e in emis:
                if e is not None:
                    e[0] += 1e-2 * np.abs(e).max()
            return state, emis
        monkeypatch.setattr(serve.CNNBackend, "collect", collect)
    elif fault == "half_batch_left_out":
        orig_pad = serve._pad_batch

        def pad(out, images):
            out = orig_pad(out, images)
            out[len(images) // 2:] = 0
            return out
        monkeypatch.setattr(serve, "_pad_batch", pad)
    elif fault == "state_unchanged":
        orig_call = graph.BatchedApply.__call__
        last: dict = {}

        def call(self, shape, fill):
            if "y" not in last:
                last["y"] = orig_call(self, shape, fill)
            return last["y"][:shape[0]]
        monkeypatch.setattr(graph.BatchedApply, "__call__", call)


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out",
                                   "state_unchanged"])
def test_broken_timed_path_is_not_correct(reduced_copy, monkeypatch, fault):
    _break(monkeypatch, fault)
    _, result = _run(reduced_copy, "resnet50.offline")
    assert result["correct"] is False
    assert result["checks"]["logit_rel_err"]["value"] > \
        result["checks"]["logit_rel_err"]["limit"]


def test_undelivered_request_is_not_correct(reduced_copy, monkeypatch):
    from repro_torch.launch import serve
    orig = serve.CNNBackend.validate_request
    seen = {"n": 0}

    def refuse_one(self, req):
        seen["n"] += 1
        return "dropped" if seen["n"] == 50 else orig(self, req)
    monkeypatch.setattr(serve.CNNBackend, "validate_request", refuse_one)
    _, result = _run(reduced_copy, "vgg16.offline")
    assert result["failed"] >= 1 and result["correct"] is False
