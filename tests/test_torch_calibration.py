"""The port's calibration (`repro_torch.core.calibration`,
``calibrate_torch.py``) against the reference's
(`repro.core.calibration`), on the CPU.

* The pure part is bit-equal: `layer_features`, `predict_time_s`,
  `_nnls` and `fit_constants` on the same synthetic features and times
  give the same numbers, and `compare_calibration` gives the same
  failures and table lines on the reference's own ``CALIB_cpu.json`` and
  on copies of it with one thing seeded wrong (a changed constant, a moved
  feature, a blown-up time, a missing gated layer).
* `measured_vs_modeled_records(measure=False)` on ResNet-18 at 32 px,
  seeded numpy weights given to both sides, gives the reference's rows
  (which have no HLO columns without the clock either).
* The CLI's fit and gate run end to end on the CPU at 32 px, and the
  committed ``CALIB_cuda.json`` reproduces its own predictions bit for
  bit and names the card it was fitted on.
"""
import copy
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from _torch_resnet_parity import weights
from repro.core import calibration as RC
from repro.models import graph as jg
from repro_torch.core import calibration as TC
from repro_torch.core.accel_model import load_calibration
from repro_torch.models import graph as tg
from repro_torch.params import params_from_numpy
from repro_torch.utils.roofline import card

ROOT = Path(__file__).resolve().parents[1]
REF_CALIB = ROOT / "benchmarks" / "baselines" / "CALIB_cpu.json"
CUDA_CALIB = ROOT / "src" / "repro_torch" / "baselines" / "CALIB_cuda.json"
sys.path.insert(0, str(ROOT))
import calibrate_torch  # noqa: E402


def _features(seed: int, n: int = 24) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [RC.layer_features(
        flops=int(2 * 32 * 128 * rng.integers(1, 2_000_000)),
        bytes_accessed=int(rng.integers(1_000, 20_000_000)),
        nb=int(rng.integers(1, 9)), s_steps=int(rng.integers(1, 40)),
        blocks=int(rng.integers(1, 200)), vk=32, vn=128,
        cycles=int(rng.integers(0, 10 ** 6))) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_features_and_prediction_are_bit_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        kw = dict(flops=int(rng.integers(0, 10 ** 12)),
                  bytes_accessed=int(rng.integers(0, 10 ** 9)),
                  nb=int(rng.integers(1, 64)), s_steps=int(rng.integers(1, 99)),
                  blocks=int(rng.integers(1, 999)),
                  vk=int(rng.choice([1, 8, 32])), vn=int(rng.choice([64, 128])))
        assert TC.layer_features(**kw) == RC.layer_features(**kw)
        assert TC.layer_features(cycles=7, **kw) == \
            RC.layer_features(cycles=7, **kw)
    consts = dict(backend="cpu", cycle_time_ns=float(rng.uniform(0.1, 9)),
                  per_tap_overhead=float(rng.uniform(0, 5)),
                  vsmm_flush_cycles=float(rng.uniform(0, 50)),
                  dma_overlap=float(rng.uniform(0, 1)),
                  fixed_overhead_us=float(rng.uniform(0, 20)),
                  hbm_gbps=20.0)
    for f in _features(seed):
        assert TC.predict_time_s(f, TC.CalibConstants(**consts)) == \
            RC.predict_time_s(f, RC.CalibConstants(**consts))


@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_constants_are_bit_equal(seed, relative):
    feats = _features(seed)
    true = RC.CalibConstants(backend="cpu", cycle_time_ns=3.0,
                             per_tap_overhead=2.0, vsmm_flush_cycles=9.0,
                             dma_overlap=0.4, fixed_overhead_us=6.0)
    noise = np.random.default_rng(seed + 10).uniform(0.7, 1.4, len(feats))
    times = [RC.predict_time_s(f, true) * e for f, e in zip(feats, noise)]
    for hbm in (None, 20.0, 3350.0):
        got = TC.fit_constants(feats, times, backend="cpu", hbm_gbps=hbm,
                               relative=relative)
        want = RC.fit_constants(feats, times, backend="cpu", hbm_gbps=hbm,
                                relative=relative)
        assert got.to_dict() == want.to_dict()
    a = np.random.default_rng(seed).standard_normal((30, 5))
    y = np.random.default_rng(seed + 1).standard_normal(30)
    assert TC._nnls(a, y).tobytes() == RC._nnls(a, y).tobytes()


@pytest.fixture(scope="module")
def ref_calib():
    return json.loads(REF_CALIB.read_text())


def _gate_rows(calib):
    gate = set(calib["gate_layers"])
    return [copy.deepcopy(r) for r in calib["rows"] if r["name"] in gate]


def _seeded(calib, what):
    """(fresh rows, calibration) with one thing seeded wrong."""
    calib = copy.deepcopy(calib)
    fresh = _gate_rows(calib)
    if what == "constant":
        calib["constants"]["cycle_time_ns"] *= 1.01
    elif what == "tap_constant":
        calib["constants"]["per_tap_overhead"] += 1.0
    elif what == "feature":
        fresh[3]["modeled_cycles"] = int(fresh[3]["modeled_cycles"] * 1.05) + 1
    elif what == "stored_feature":
        calib["rows"][5]["features"]["mxu_steps"] += 1000
    elif what == "blowup":
        fresh[0]["measured_us"] *= 100.0
    elif what == "slower_machine":
        for r in fresh:
            r["measured_us"] *= 8.0
    elif what == "absurd_scale":
        for r in fresh:
            r["measured_us"] *= 1000.0
    elif what == "missing":
        fresh = fresh[1:]
    elif what == "no_hlo":
        for r in fresh + calib["rows"]:
            for k in ("hlo_flops", "hlo_bytes", "measured_ai",
                      "flops_model_ratio"):
                r.pop(k)
    return fresh, calib


@pytest.mark.parametrize("what", [
    "identical", "constant", "tap_constant", "feature", "stored_feature",
    "blowup", "slower_machine", "absurd_scale", "missing", "no_hlo"])
def test_drift_gate_matches_reference(ref_calib, what):
    fresh, calib = _seeded(ref_calib, what)
    got = TC.compare_calibration(copy.deepcopy(fresh), calib)
    want = RC.compare_calibration(copy.deepcopy(fresh), calib)
    assert got == want
    failures, lines = got
    assert bool(failures) == (what not in ("identical", "slower_machine",
                                           "no_hlo"))
    assert lines[0].startswith("| layer |")


def test_records_without_the_clock_match_reference():
    jnet = jg.build_resnet18(200, image_size=32)
    tnet = tg.build_resnet18(200, image_size=32)
    tree = weights(jnet)
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    want = RC.measured_vs_modeled_records(jnet, tree, x, measure=False)
    got = TC.measured_vs_modeled_records(
        tnet, params_from_numpy(tree, "cpu"), torch.from_numpy(x),
        measure=False)
    assert len(got) == 21
    assert got == want


def test_measured_rows_on_the_cpu():
    """measure=True on two layers: the modeled columns of measure=False
    and a positive time (the plain path, perf_counter)."""
    net = tg.build_resnet18(10, image_size=32)
    params = params_from_numpy(weights(net), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    layers = {"resnet18/layer2_0_down", "resnet18/fc"}
    model = TC.measured_vs_modeled_records(net, params, x, layers=layers,
                                           measure=False)
    timed = TC.measured_vs_modeled_records(net, params, x, layers=layers,
                                           repeats=2, warmup=1)
    assert [r["name"] for r in timed] == ["resnet18/layer2_0_down",
                                          "resnet18/fc"]
    for m, t in zip(model, timed):
        assert t.pop("measured_us") > 0
        assert t == m
    assert TC.median_time_s(lambda a: a + 1, torch.ones(4)) > 0


def test_persistence_and_paths(tmp_path, monkeypatch):
    feats = _features(3, 6)
    c = TC.fit_constants(feats, [1e-5 * (i + 1) for i in range(6)],
                         backend="cpu")
    assert c.backend == "cpu" and c.hbm_gbps == TC.CPU_HBM_GBPS
    rows = TC.attach_predictions([{"name": f"n/l{i}", "features": f}
                                  for i, f in enumerate(feats)], c)
    path = tmp_path / "CALIB_cpu.json"
    TC.save_calibration(path, c, rows, fit_settings={"x": 1})
    art = TC.load_calibration_file(path)
    assert art["gate_layers"] == [r["name"] for r in rows]
    assert TC.load_constants("cpu", path=path) == c
    assert load_calibration("cpu", path=str(path)) == c
    assert TC.compare_calibration(rows, art)[0] == []
    assert TC.default_calib_path("cuda") == CUDA_CALIB
    monkeypatch.setenv("VSCNN_CALIB_PATH", str(path))
    assert TC.default_calib_path("cuda") == path
    assert TC.load_constants("cpu") == c
    monkeypatch.setenv("VSCNN_CALIB_PATH", str(tmp_path / "none.json"))
    assert not TC.load_constants("cpu").calibrated
    assert TC.backend_hbm_gbps("cuda", "NVIDIA H100 80GB HBM3") == 3350.0
    assert TC.backend_hbm_gbps("cpu") == TC.CPU_HBM_GBPS


def test_cli_fit_and_gate_on_the_cpu(tmp_path, capsys):
    """``run_fit`` then ``gate_calibration`` on ResNet-18 at 32 px, batch
    1, on the CPU: 21 layers fitted and gated, the artifact's constants
    reproduce its predictions.  The band is wide: on the CPU under
    parallel test workers the times only test the plumbing."""
    path = tmp_path / "CALIB_cpu.json"
    assert calibrate_torch.run_fit(
        str(path), nets=("vgg16", "resnet18"), repeats=1, warmup=1,
        device="cpu", image_size=32, batch=1, num_classes=200) == 0
    art = TC.load_calibration_file(path)
    assert art["fit"]["image_size"] == 32 and art["fit"]["batch"] == 1
    assert len(art["gate_layers"]) == 21
    assert all(n.startswith("resnet18/") for n in art["gate_layers"])
    assert len(art["rows"]) == 21 + 16
    gate = calibrate_torch.gate_calibration(str(path), band=1e9, repeats=1,
                                            warmup=1, device="cpu")
    assert gate["failures"] == [] and gate["layers"] == 21
    assert gate["scale"] > 0 and gate["worst"][0] in art["gate_layers"]
    assert "calibration gate: PASS" in capsys.readouterr().out


def test_committed_cuda_calibration():
    """The artifact fitted on the card: every conv and FC layer of the
    five nets at 224 px, batch 8; its constants reproduce every stored
    ``predicted_us`` bit for bit; its fit settings name the card."""
    calib = json.loads(CUDA_CALIB.read_text())
    fit = calib["fit"]
    assert (fit["image_size"], fit["batch"], fit["num_classes"],
            fit["density"]) == (224, 8, 1000, 0.5)
    assert fit["nvidia_smi"] and "W" in fit["nvidia_smi"]
    assert fit["device"] in fit["nvidia_smi"]
    c = TC.CalibConstants.from_dict(calib["constants"])
    assert c.backend == "cuda" and c.calibrated
    for r in calib["rows"]:
        assert TC.predict_time_s(r["features"], c) * 1e6 == r["predicted_us"]
        assert r["measured_us"] > 0
    per_net = {}
    for r in calib["rows"]:
        per_net[r["net"]] = per_net.get(r["net"], 0) + 1
    nets = {"vgg16": tg.build_vgg16, "resnet18": tg.build_resnet18,
            "resnet34": tg.build_resnet34, "resnet50": tg.build_resnet50,
            "mobilenet_v1": tg.build_mobilenet_v1}
    assert per_net == {n: len(b().conv_layers()) + len(b().fc_layers())
                       for n, b in nets.items()}
    assert calib["gate_layers"] == [r["name"] for r in calib["rows"]
                                    if r["net"] == "resnet18"]
    assert len(calib["gate_layers"]) == 21
    assert dataclasses.asdict(c) == calib["constants"]
    assert c.hbm_gbps == card(fit["device"]).hbm_gbps
