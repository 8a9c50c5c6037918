#!/usr/bin/env python3
"""Calibration CLI of the port: time every layer, fit the cost model.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 calibrate_torch.py [--fit | --gate-calibration] [--device cpu]

It closes the measured-vs-modeled loop of `repro_torch.core.calibration`
(the port of ``benchmarks/calibrate.py``):

1. Default run: walk every conv and FC layer of the five registered CNNs
   (VGG-16, ResNet-18/34/50, MobileNetV1) at full width — 224 px, batch
   8, 1000 classes, f32, density 0.5, seeded random weights and seeded
   images — through the served sparse path (``impl="pallas-halo"``: the
   halo build, the kernel and its fused epilogue), each layer captured as
   a CUDA graph and timed by CUDA events over its replays (median of
   ``--repeats`` after ``--warmup``), beside the analytic model's
   numbers; print one JSON row per layer.
2. ``--fit``: non-negative least squares over those measurements fits the
   time model's free constants and writes the calibration artifact —
   constants, fit settings (the card's name and power limit as
   ``nvidia-smi`` gives them, the torch version, the geometry) and every
   per-layer record with its ``predicted_us`` — to
   ``src/repro_torch/baselines/CALIB_<backend>.json`` (or ``--baseline``).
   Refit ``CALIB_cuda.json`` only from a run on the card.
3. ``--gate-calibration``: the drift gate.  Re-measures the gated layer
   subset (ResNet-18's 21 conv and FC layers) and fails when the
   prediction leaves its band: bit-exact round trip of the stored
   constants to the stored predictions, a tight band (default 2%) on the
   deterministic model features, and a wide machine-normalized band
   (default 4x) on the fresh times.

The backend is the device's type: ``cuda`` by default, ``cpu`` with
``--device cpu`` (the plain path, timed by ``perf_counter``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Full width: the geometry the port serves on the card.
IMAGE_SIZE = 224
BATCH = 8
NUM_CLASSES = 1000
DEFAULT_DENSITY = 0.5
DEFAULT_NETS = ("vgg16", "resnet18", "resnet34", "resnet50", "mobilenet_v1")
SERVED_IMPL = "pallas-halo"
# The gate re-measures one small net: every feature family (7x7 stem, 3x3,
# 1x1 projection, stride-2 downsample, FC head) appears in its 21 layers.
GATE_NET = "resnet18"


def _builders() -> dict:
    from repro_torch.models.graph import (
        build_mobilenet_v1, build_resnet18, build_resnet34, build_resnet50,
        build_vgg16,
    )
    return {
        "vgg16": build_vgg16,
        "resnet18": build_resnet18,
        "resnet34": build_resnet34,
        "resnet50": build_resnet50,
        "mobilenet_v1": build_mobilenet_v1,
    }


def collect_records(nets=DEFAULT_NETS, *, density: float = DEFAULT_DENSITY,
                    repeats: int = 5, warmup: int = 2,
                    layers: set[str] | None = None, measure: bool = True,
                    device=None, image_size: int = IMAGE_SIZE,
                    batch: int = BATCH,
                    num_classes: int = NUM_CLASSES) -> list[dict]:
    """Measured-vs-modeled rows for every conv/FC layer of ``nets``: net
    i's weights from seed i, its images from numpy seed 100 + i."""
    import numpy as np
    import torch

    from repro_torch.core.calibration import measured_vs_modeled_records
    from repro_torch.core.device import resolve_device
    from repro_torch.models.layers import init_params

    dev = resolve_device(device)
    builders = _builders()
    rows: list[dict] = []
    for i, name in enumerate(nets):
        net = builders[name](num_classes, image_size=image_size)
        if layers is not None and not any(
                ln.startswith(f"{net.name}/") for ln in layers):
            continue
        params = init_params(net.schema(), i, device=dev)
        rng = np.random.default_rng(100 + i)
        x = torch.from_numpy(rng.standard_normal(
            (batch, image_size, image_size, 3)).astype(np.float32)).to(dev)
        rows += measured_vs_modeled_records(
            net, params, x, density=density, impl=SERVED_IMPL,
            repeats=repeats, warmup=warmup, layers=layers, measure=measure)
    return rows


def run_fit(out_path: str | None, *, nets=DEFAULT_NETS,
            density: float = DEFAULT_DENSITY, repeats: int = 5,
            warmup: int = 2, device=None, image_size: int = IMAGE_SIZE,
            batch: int = BATCH, num_classes: int = NUM_CLASSES) -> int:
    """Measure everything, fit the constants, write the artifact (the
    geometry defaults to the full width; the gate re-reads it from the
    artifact)."""
    import torch

    from repro_torch.core.calibration import (attach_predictions,
                                              default_calib_path,
                                              fit_constants,
                                              save_calibration)
    from repro_torch.core.device import resolve_device
    from repro_torch.utils.roofline import smi_name_and_power

    dev = resolve_device(device)
    backend = dev.type
    rows = collect_records(nets, density=density, repeats=repeats,
                           warmup=warmup, device=dev, image_size=image_size,
                           batch=batch, num_classes=num_classes)
    constants = fit_constants(
        [r["features"] for r in rows],
        [r["measured_us"] * 1e-6 for r in rows],
        backend=backend)
    attach_predictions(rows, constants)
    path = out_path or default_calib_path(backend)
    gate_layers = [r["name"] for r in rows if r["net"] == GATE_NET]
    save_calibration(
        path, constants, rows,
        fit_settings={
            "nets": list(nets),
            "image_size": image_size,
            "batch": batch,
            "num_classes": num_classes,
            "dtype": "f32",
            "density": density,
            "impl": SERVED_IMPL,
            "repeats": repeats,
            "warmup": warmup,
            "weighting": "relative",
            "timing": ("CUDA graph replays, CUDA events" if backend == "cuda"
                       else "perf_counter"),
            "device": (torch.cuda.get_device_name(dev)
                       if backend == "cuda" else "cpu"),
            "nvidia_smi": (smi_name_and_power() if backend == "cuda"
                           else None),
            "torch": torch.__version__,
        },
        gate_layers=gate_layers)
    print(f"fitted {backend} constants over {len(rows)} layers "
          f"({len(nets)} nets):")
    for k, v in constants.to_dict().items():
        print(f"  {k:>18}: {v}")
    ratios = sorted(r["measured_us"] / max(r["predicted_us"], 1e-9)
                    for r in rows)
    print(f"measured/predicted ratio: min {ratios[0]:.2f} / median "
          f"{ratios[len(ratios) // 2]:.2f} / max {ratios[-1]:.2f}")
    print(f"wrote {path} (gate subset: {len(gate_layers)} {GATE_NET} layers)")
    return 0


def gate_calibration(baseline_path: str | None, *, band: float = 4.0,
                     feature_tol: float = 0.02, repeats: int = 5,
                     warmup: int = 2, device=None) -> dict:
    """The drift gate: re-measure the gated subset against the committed
    calibration.  Returns {"failures", "lines", "layers", "scale",
    "worst"}: ``scale`` is the median measured/predicted over the gated
    layers, ``worst`` the layer whose scale-normalized ratio is furthest
    from 1 and that ratio."""
    import numpy as np

    from repro_torch.core.calibration import (CalibConstants,
                                              compare_calibration,
                                              default_calib_path,
                                              load_calibration_file,
                                              predict_time_s)
    from repro_torch.core.device import resolve_device

    dev = resolve_device(device)
    path = baseline_path or default_calib_path(dev.type)
    calib = load_calibration_file(path)
    fit = calib.get("fit", {})
    gate_layers = set(calib["gate_layers"])
    fresh = collect_records(
        tuple(fit.get("nets", DEFAULT_NETS)),
        density=fit.get("density", DEFAULT_DENSITY),
        repeats=repeats, warmup=warmup, layers=gate_layers, device=dev,
        image_size=fit.get("image_size", IMAGE_SIZE),
        batch=fit.get("batch", BATCH),
        num_classes=fit.get("num_classes", NUM_CLASSES))
    failures, lines = compare_calibration(
        fresh, calib, feature_tol=feature_tol, band=band)
    const = CalibConstants.from_dict(calib["constants"])
    stored = {r["name"]: r for r in calib["rows"]}
    ratios = {f["name"]: f["measured_us"]
              / max(predict_time_s(stored[f["name"]]["features"], const)
                    * 1e6, 1e-9)
              for f in fresh if f["name"] in stored and "measured_us" in f}
    scale = float(np.median(list(ratios.values()))) if ratios else None
    worst = None
    if ratios:
        name = max(ratios, key=lambda n: abs(np.log(ratios[n] / scale)))
        worst = (name, ratios[name] / scale)
    summary = "\n".join(
        [f"## Calibration drift gate — `{path}` "
         f"({'FAIL' if failures else 'PASS'})", ""]
        + lines + [""]
        + [f"- {f}" for f in failures])
    print(summary)
    print(f"calibration gate: {'FAIL' if failures else 'PASS'}"
          + (f" ({len(failures)} drift(s))" if failures else ""))
    return {"failures": failures, "lines": lines, "layers": len(fresh),
            "scale": scale, "worst": worst}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--fit", action="store_true",
                    help="fit the model constants to fresh measurements and "
                         "write src/repro_torch/baselines/CALIB_<backend>"
                         ".json")
    ap.add_argument("--gate-calibration", action="store_true",
                    help="drift gate: re-measure the gated layer subset "
                         "and fail if prediction error leaves the band")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="calibration artifact to fit into / gate against "
                         "(default: src/repro_torch/baselines/"
                         "CALIB_<backend>.json)")
    ap.add_argument("--nets", default=",".join(DEFAULT_NETS),
                    help="comma-separated net list for measurement/fit")
    ap.add_argument("--density", type=float, default=DEFAULT_DENSITY)
    ap.add_argument("--repeats", type=int, default=5,
                    help="median-of-k repeats per layer")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--band", type=float, default=4.0,
                    help="measured-time band (x) for --gate-calibration")
    ap.add_argument("--feature-tol", type=float, default=0.02,
                    help="tight relative band for deterministic features")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "path)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    nets = tuple(n for n in args.nets.split(",") if n)
    if args.gate_calibration:
        gate = gate_calibration(
            args.baseline, band=args.band, feature_tol=args.feature_tol,
            repeats=args.repeats, warmup=args.warmup, device=args.device)
        return 1 if gate["failures"] else 0
    if args.fit:
        return run_fit(args.baseline, nets=nets, density=args.density,
                       repeats=args.repeats, warmup=args.warmup,
                       device=args.device)
    for r in collect_records(nets, density=args.density,
                             repeats=args.repeats, warmup=args.warmup,
                             device=args.device):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
