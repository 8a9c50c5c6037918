"""Measured-vs-modeled calibration of the analytic cost model (the port's
copy of `repro/core/calibration.py`).

Run every conv and FC layer of a real network, time it, take the analytic
model's deterministic features (`core.accel_model`: the paper's cycle
model and the reference's traffic model), fit the model's free constants
to the measurements, and persist them, so that modeled numbers are
calibrated, not guessed.

The time model
--------------
Predicted time of one layer on the sparse path::

    t = cycle_time_ns * 1e-9
          * (mxu_steps
             + per_tap_overhead   * taps
             + vsmm_flush_cycles  * flushes)
      + (1 - dma_overlap) * bytes / (hbm_gbps * 1e9)
      + fixed_overhead_us * 1e-6

with per-layer features from the analytic model (deterministic functions
of the encoded geometry):

    mxu_steps  modeled FLOPs / (2 * vk * vn) — vector MAC-row issues, the
               analogue of the paper's PE-array cycles
    taps       sparse grid steps (stored tiles x row-blocks)
    flushes    output-strip flushes (the fused epilogue)
    bytes      modeled DRAM bytes (`TrafficReport.bytes_accessed`, halo)

The fit is a deterministic non-negative least squares (active set on top
of ``np.linalg.lstsq``) over per-layer median-of-k measurements.

Backends and measurement
------------------------
The backend is ``"cuda"`` or ``"cpu"``, the device of the layer's input.
On CUDA, `median_time_s` captures one call of the layer's function (the
halo build, the kernel and its epilogue) as a CUDA graph
(`kernels.capture`) and times its replays with CUDA events; on the CPU it
times the plain path with ``perf_counter``.  The byte term divides by the
card's datasheet HBM rate (`utils.roofline`), never fitted.  The reference
also records the compiled program's FLOPs and bytes parsed from its XLA
HLO; those columns have no counterpart here, and the drift gate checks
only the keys a row has.

Persistence + drift gate
------------------------
`fit_constants` -> `save_calibration` writes ``CALIB_<backend>.json``
(``src/repro_torch/baselines/``; ``VSCNN_CALIB_PATH`` overrides it): the
constants, the fit settings, and every per-layer record with its
``predicted_us``.  `load_constants` finds it again
(`accel_model.load_calibration` is the public hook), and
`compare_calibration` is the drift gate: bit-exact reproduction of the
recorded predictions from the stored constants + features, a tight band
on the deterministic model features, and a machine-normalized wide band
on fresh measurements.  ``calibrate_torch.py`` is the CLI.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import pathlib
import time
from typing import Any, Callable

import numpy as np

__all__ = [
    "CalibConstants", "layer_features", "predict_time_s", "fit_constants",
    "save_calibration", "load_calibration_file", "load_constants",
    "default_calib_path", "backend_hbm_gbps", "median_time_s",
    "measured_vs_modeled_records", "attach_predictions",
    "compare_calibration", "CPU_HBM_GBPS",
]

# Nominal host-DRAM stream bandwidth for the CPU backend: the denominator
# of the byte term, never fitted (dma_overlap is the fitted knob).  The
# CUDA backend reads its card's datasheet rate (`backend_hbm_gbps`).
CPU_HBM_GBPS = 20.0


def backend_hbm_gbps(backend: str, device_name: str | None = None) -> float:
    """The byte term's bandwidth in GB/s: `CPU_HBM_GBPS` for ``"cpu"``,
    the card's datasheet HBM rate (`utils.roofline.card`) for ``"cuda"``
    (``device_name`` defaults to the current device's)."""
    if backend != "cuda":
        return CPU_HBM_GBPS
    from repro_torch.utils.roofline import card
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_name(0)
    return card(device_name).hbm_gbps


@dataclasses.dataclass(frozen=True)
class CalibConstants:
    """The cost model's free constants, fitted per backend.

    ``cycle_time_ns`` is nanoseconds per vector MAC-row (mxu_step);
    ``per_tap_overhead`` / ``vsmm_flush_cycles`` are in cycles (multiples
    of ``cycle_time_ns``); ``dma_overlap`` in [0, 1] is the fraction of
    modeled bytes overlapped with compute (1.0 = traffic fully hidden);
    ``fixed_overhead_us`` is the per-launch floor.  ``hbm_gbps`` is the
    nominal bandwidth the byte term divides by (recorded, not fitted).
    The default instance is *uncalibrated*: pure cycle proportionality
    with everything else zeroed.
    """

    backend: str = "uncalibrated"
    cycle_time_ns: float = 0.0
    per_tap_overhead: float = 0.0
    vsmm_flush_cycles: float = 0.0
    dma_overlap: float = 1.0
    fixed_overhead_us: float = 0.0
    hbm_gbps: float = CPU_HBM_GBPS

    @property
    def calibrated(self) -> bool:
        return self.cycle_time_ns > 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CalibConstants":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# --------------------------------------------------------------------------
# Features
# --------------------------------------------------------------------------

def layer_features(*, flops: int, bytes_accessed: int, nb: int, s_steps: int,
                   blocks: int, vk: int, vn: int,
                   cycles: int | None = None) -> dict:
    """Deterministic per-layer features of the time model.

    ``blocks`` is the number of spatial grid blocks the reference's kernel
    sweeps per strip — ``n * ceil(Hout / bh)`` for a conv, ``ceil(M /
    bm)`` for the matmul path (1x1 convs over flattened pixels, FC
    layers).  ``cycles`` optionally carries the paper-model vscnn cycles
    for reporting; it is not a fit feature.
    """
    feat = {
        "mxu_steps": int(flops) // max(2 * vk * vn, 1),
        "taps": int(nb) * int(s_steps) * int(blocks),
        "flushes": int(nb) * int(blocks),
        "bytes": int(bytes_accessed),
        "flops": int(flops),
    }
    if cycles is not None:
        feat["cycles"] = int(cycles)
    return feat


def predict_time_s(feat: dict, c: CalibConstants) -> float:
    """The calibrated time model — seconds for one layer's features."""
    cyc = (feat["mxu_steps"]
           + c.per_tap_overhead * feat["taps"]
           + c.vsmm_flush_cycles * feat["flushes"])
    t = c.cycle_time_ns * 1e-9 * cyc + c.fixed_overhead_us * 1e-6
    if c.hbm_gbps > 0.0:
        t += (1.0 - c.dma_overlap) * feat["bytes"] / (c.hbm_gbps * 1e9)
    return t


# --------------------------------------------------------------------------
# Fitting
# --------------------------------------------------------------------------

def _nnls(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Deterministic non-negative least squares: plain lstsq, then drop the
    most-negative column and re-solve until every kept coefficient is
    >= 0.  Small (5-column) systems only — exactness over generality."""
    cols = list(range(A.shape[1]))
    coef = np.zeros(A.shape[1])
    while cols:
        sol, *_ = np.linalg.lstsq(A[:, cols], y, rcond=None)
        if (sol >= 0).all():
            for c_idx, v in zip(cols, sol):
                coef[c_idx] = v
            break
        cols.pop(int(np.argmin(sol)))
    return coef


def fit_constants(features: list[dict], measured_s: list[float], *,
                  backend: str, hbm_gbps: float | None = None,
                  relative: bool = True) -> CalibConstants:
    """Least-squares fit of the free constants to measured times.

    The model is linear in (a0..a4) = (cycle_time, cycle_time*per_tap,
    cycle_time*flush, 1-dma_overlap, fixed), so one non-negative lstsq
    solves it; the named constants are recovered by dividing through a0.
    ``relative`` (default) weights each row by 1/measured so the fit
    minimizes *relative* error — the quantity the drift gate bands —
    instead of letting the few biggest layers dominate.  Deterministic:
    same features + times -> bit-identical constants.  ``hbm_gbps``
    defaults to `backend_hbm_gbps(backend)`.
    """
    if hbm_gbps is None:
        hbm_gbps = backend_hbm_gbps(backend)
    A = np.array([
        [f["mxu_steps"], f["taps"], f["flushes"],
         f["bytes"] / (hbm_gbps * 1e9), 1.0]
        for f in features
    ], dtype=np.float64)
    y = np.asarray(measured_s, dtype=np.float64)
    if relative:
        w = 1.0 / np.maximum(y, 1e-12)
        A = A * w[:, None]
        y = y * w
    # column scaling keeps lstsq well-conditioned across 1e0..1e9 features
    scale = np.maximum(np.abs(A).max(axis=0), 1e-30)
    coef = _nnls(A / scale, y) / scale
    a0, a1, a2, a3, a4 = coef
    return CalibConstants(
        backend=backend,
        cycle_time_ns=a0 * 1e9,
        per_tap_overhead=(a1 / a0) if a0 > 0 else 0.0,
        vsmm_flush_cycles=(a2 / a0) if a0 > 0 else 0.0,
        dma_overlap=float(np.clip(1.0 - a3, 0.0, 1.0)),
        fixed_overhead_us=a4 * 1e6,
        hbm_gbps=hbm_gbps,
    )


# --------------------------------------------------------------------------
# Persistence
# --------------------------------------------------------------------------

def default_calib_path(backend: str) -> pathlib.Path:
    """``src/repro_torch/baselines/CALIB_<backend>.json`` (overridable via
    the ``VSCNN_CALIB_PATH`` environment variable)."""
    env = os.environ.get("VSCNN_CALIB_PATH")
    if env:
        return pathlib.Path(env)
    pkg = pathlib.Path(__file__).resolve().parents[1]
    return pkg / "baselines" / f"CALIB_{backend}.json"


def save_calibration(path: str | pathlib.Path, constants: CalibConstants,
                     rows: list[dict], *, fit_settings: dict | None = None,
                     gate_layers: list[str] | None = None) -> dict:
    """Write the calibration artifact: constants + per-layer records.

    Every row must already carry its ``features`` and ``predicted_us``
    (recomputed bit-exactly by the drift gate), plus ``measured_us``.
    """
    artifact = {
        "calib": "measured_vs_modeled",
        "constants": constants.to_dict(),
        "fit": fit_settings or {},
        "gate_layers": gate_layers or [r["name"] for r in rows],
        "rows": rows,
    }
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    return artifact


def load_calibration_file(path: str | pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_constants(backend: str | None = None,
                   path: str | pathlib.Path | None = None
                   ) -> CalibConstants:
    """Fitted constants for ``backend`` (default: ``"cuda"`` where a card
    is visible, else ``"cpu"``).

    Returns the uncalibrated defaults when no ``CALIB_<backend>.json``
    exists — modeled numbers then fall back to pure cycle proportionality
    rather than failing.
    """
    if backend is None:
        import torch
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    p = pathlib.Path(path) if path else default_calib_path(backend)
    if not p.exists():
        return CalibConstants(backend=backend)
    return CalibConstants.from_dict(load_calibration_file(p)["constants"])


# --------------------------------------------------------------------------
# Measurement
# --------------------------------------------------------------------------

def median_time_s(fn: Callable[..., Any], *args: Any, repeats: int = 5,
                  warmup: int = 2) -> float:
    """Median-of-k time of one call of ``fn(*args)``.

    On CUDA inputs the call is captured once as a CUDA graph
    (`kernels.capture.capture`, which warms it up eagerly first) and each
    of ``repeats`` replays, after ``warmup`` untimed ones, is timed with
    CUDA events: device time with no host launch cost.  On the CPU each
    call is timed with ``perf_counter``.  Median, not mean: one outlier
    must not move the statistic.
    """
    import torch

    if any(getattr(a, "is_cuda", False) for a in args):
        from repro_torch.kernels.capture import capture

        with torch.inference_mode():
            graph, _ = capture(lambda: fn(*args))
        for _ in range(max(warmup, 1)):
            graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ts = []
        for _ in range(max(repeats, 1)):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
    else:
        with torch.inference_mode():
            for _ in range(max(warmup, 1)):
                fn(*args)
            ts = []
            for _ in range(max(repeats, 1)):
                t0 = time.perf_counter()
                fn(*args)
                ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _conv_blocks(n: int, ho: int, bh: int = 8) -> int:
    return n * math.ceil(ho / min(bh, ho))


def _matmul_blocks(m: int, bm: int = 8) -> int:
    return math.ceil(m / bm)


def measured_vs_modeled_records(
    net: Any, params: Any, x: Any, *, density: float = 0.5, vk: int = 32,
    vn: int = 128, impl: str = "auto", repeats: int = 5, warmup: int = 2,
    layers: set[str] | None = None, measure: bool = True,
) -> list[dict]:
    """Per-layer measured-vs-modeled records for one network.

    Runs every conv *and* FC layer of ``net`` through the sparse path
    (`models.graph.apply_sparse_conv` / `apply_sparse_fc` with ``impl``;
    ``"auto"`` is the kernels on CUDA inputs, over the halo layout, and
    the plain path on the CPU) as a standalone function on its real
    forward-pass input: the median-of-``repeats`` time after ``warmup``
    (`median_time_s`), the analytic model's cycles/bytes/AI, and the time
    model's features.  ``layers`` restricts to a named subset (the gate's
    fast re-measure); ``measure=False`` skips the clock and returns the
    deterministic model side only.

    Times layers in isolation (no residual input, fused epilogue on): the
    per-layer contract the fitted constants describe.
    """
    import torch

    from repro_torch.models.graph import (
        SparseConv, apply_sparse_conv, apply_sparse_fc, net_apply, sparsify,
    )

    from .accel_model import (
        PE_4_14_3, conv_layer_cycles, conv_layer_traffic, to_numpy,
    )
    from .sparse_ops import same_pads

    sparse, pruned = sparsify(net, params, density, vk=vk, vn=vn)
    conv_rec: list = []
    fc_rec: list = []
    with torch.inference_mode():
        net_apply(net, pruned, x, collect=conv_rec, collect_fc=fc_rec)
    rows = []

    for name, xin, w, stride, groups, dilation in conv_rec:
        if layers is not None and f"{net.name}/{name}" not in layers:
            continue
        spec: SparseConv = sparse[name]
        nb, s_steps, vk_l, vn_l = (int(d) for d in spec.vs.vals.shape)
        n, h, width, cin = xin.shape
        x_shape = (n, h, width, cin + spec.cin_pad)
        tr = conv_layer_traffic(
            x_shape, kh=spec.kh, kw=spec.kw, stride=spec.stride,
            groups=spec.groups, dilation=spec.dilation, cout=nb * vn_l,
            s_steps=s_steps, vk=vk_l, vn=vn_l, impl="halo",
            itemsize=spec.vs.vals.element_size())
        rep = conv_layer_cycles(
            to_numpy(xin[0]), to_numpy(w), PE_4_14_3, stride=stride,
            groups=groups, dilation=dilation)
        ho = same_pads(h, spec.kh, spec.stride, spec.dilation)[0]
        wo = same_pads(width, spec.kw, spec.stride, spec.dilation)[0]
        if spec.kh == 1 and spec.kw == 1 and spec.groups == 1:
            blocks = _matmul_blocks(n * ho * wo)
        else:
            blocks = _conv_blocks(n, ho)
        feat = layer_features(
            flops=tr.flops, bytes_accessed=tr.bytes_accessed, nb=nb,
            s_steps=s_steps, blocks=blocks, vk=vk_l, vn=vn_l,
            cycles=rep.vscnn)
        layer = next(l for l in net.conv_layers() if l.name == name)
        row = {
            "name": f"{net.name}/{name}",
            "net": net.name,
            "layer": name,
            "kind": "conv",
            "density": density,
            "features": feat,
            "modeled_cycles": rep.vscnn,
            "modeled_flops": tr.flops,
            "modeled_bytes": tr.bytes_accessed,
            "modeled_ai": round(tr.arithmetic_intensity, 4),
        }
        if measure:
            fn = functools.partial(
                apply_sparse_conv, entry=spec, bias=spec.bias,
                fuse_relu=layer.relu, impl=impl)
            row.update(_measured_cols(fn, xin, repeats=repeats,
                                      warmup=warmup))
        rows.append(row)

    for name, xin, w in fc_rec:
        if layers is not None and f"{net.name}/{name}" not in layers:
            continue
        if name not in sparse:
            continue
        spec = sparse[name]
        nb, s_steps, vk_l, vn_l = (int(d) for d in spec.vs.vals.shape)
        m, din = int(np.prod(xin.shape[:-1])), xin.shape[-1]
        tr = conv_layer_traffic(
            (m, 1, 1, din), kh=1, kw=1, cout=nb * vn_l, s_steps=s_steps,
            vk=vk_l, vn=vn_l, impl="halo",
            itemsize=spec.vs.vals.element_size())
        rep = conv_layer_cycles(
            to_numpy(xin).reshape(m, 1, din),
            to_numpy(w)[None, None], PE_4_14_3)
        feat = layer_features(
            flops=tr.flops, bytes_accessed=tr.bytes_accessed, nb=nb,
            s_steps=s_steps, blocks=_matmul_blocks(m), vk=vk_l, vn=vn_l,
            cycles=rep.vscnn)
        layer = next(l for l in net.fc_layers() if l.name == name)
        row = {
            "name": f"{net.name}/{name}",
            "net": net.name,
            "layer": name,
            "kind": "fc",
            "density": density,
            "features": feat,
            "modeled_cycles": rep.vscnn,
            "modeled_flops": tr.flops,
            "modeled_bytes": tr.bytes_accessed,
            "modeled_ai": round(tr.arithmetic_intensity, 4),
        }
        if measure:
            fn = functools.partial(apply_sparse_fc, entry=spec,
                                   bias=spec.bias, fuse_relu=layer.relu,
                                   impl=impl)
            row.update(_measured_cols(fn, xin, repeats=repeats,
                                      warmup=warmup))
        rows.append(row)
    return rows


def _measured_cols(fn: Callable[..., Any], xin: Any, *, repeats: int,
                   warmup: int) -> dict:
    t = median_time_s(fn, xin, repeats=repeats, warmup=warmup)
    return {"measured_us": round(t * 1e6, 3)}


def attach_predictions(rows: list[dict], c: CalibConstants) -> list[dict]:
    """Fill each record's ``predicted_us`` from its features + constants."""
    for r in rows:
        r["predicted_us"] = predict_time_s(r["features"], c) * 1e6
    return rows


# --------------------------------------------------------------------------
# Drift gate
# --------------------------------------------------------------------------

def compare_calibration(
    fresh_rows: list[dict], calib: dict, *, feature_tol: float = 0.02,
    band: float = 4.0, scale_limits: tuple[float, float] = (0.02, 50.0),
) -> tuple[list[str], list[str]]:
    """The drift gate: fresh per-layer records vs the committed
    calibration.  Returns ``(failures, markdown table lines)``.

    Three checks, tightest first:

    1. **Constants round-trip (exact).**  The stored constants + each
       row's stored features must reproduce the stored ``predicted_us``
       bit-exactly — perturbing any fitted constant (or any feature) fails
       here, which is what makes the gate testable without a clock.
    2. **Deterministic features (tight band).**  Fresh modeled
       cycles/bytes/FLOPs must stay within ``feature_tol`` of the recorded
       values: cost-model drift is caught independent of machine speed.
    3. **Measured time (wide band, machine-normalized).**  One global
       scale — the median of measured/predicted over the gated layers —
       absorbs this machine's clock vs the fit machine's; every layer's
       scale-normalized ratio must then stay within ``band``x.  The scale
       itself must sit inside ``scale_limits`` (a sanity rail).
    """
    const = CalibConstants.from_dict(calib["constants"])
    stored = {r["name"]: r for r in calib["rows"]}
    failures: list[str] = []
    lines = [
        "| layer | check | recorded | fresh | delta | status |",
        "|---|---|---|---|---|---|",
    ]

    def _check(name: str, check: str, rec: float, new: float,
               tol: float) -> None:
        delta = (new - rec) / max(abs(rec), 1e-12)
        bad = abs(delta) > tol
        if bad:
            failures.append(
                f"{name}: {check} {rec:g} -> {new:g} ({delta:+.2%}, "
                f"tol ±{tol:.0%})")
        lines.append(f"| {name} | {check} | {rec:g} | {new:g} | "
                     f"{delta:+.2%} | {'FAIL' if bad else 'ok'} |")

    # 1. constants + stored features must reproduce stored predictions
    for r in calib["rows"]:
        want = r.get("predicted_us")
        if want is None:
            continue
        got = predict_time_s(r["features"], const) * 1e6
        if not math.isclose(got, want, rel_tol=1e-9, abs_tol=1e-12):
            failures.append(
                f"{r['name']}: constants do not reproduce recorded "
                f"predicted_us ({want:g} recorded, {got:g} recomputed) — "
                f"a fitted constant or feature was changed without refitting")
            lines.append(f"| {r['name']} | predicted_us round-trip | "
                         f"{want:g} | {got:g} | — | FAIL |")

    # 2 + 3. fresh measurements vs the record
    ratios = []
    for f in fresh_rows:
        r = stored.get(f["name"])
        if r is None:
            continue  # newly added layer: nothing recorded to drift from
        for key in ("hlo_flops", "hlo_bytes", "modeled_cycles",
                    "modeled_bytes", "modeled_flops"):
            if key in r and key in f:
                _check(f["name"], key, float(r[key]), float(f[key]),
                       feature_tol)
        if "measured_us" in f:
            pred = predict_time_s(r["features"], const) * 1e6
            ratios.append((f["name"], f["measured_us"], pred))
    missing = [n for n in calib.get("gate_layers", []) if n not in
               {f["name"] for f in fresh_rows}]
    for n in missing:
        failures.append(f"{n}: gated layer missing from fresh records")
        lines.append(f"| {n} | presence | — | MISSING | — | FAIL |")

    if ratios:
        scale = float(np.median([m / max(p, 1e-9) for _, m, p in ratios]))
        lo, hi = scale_limits
        if not (lo <= scale <= hi):
            failures.append(
                f"global wall-clock scale {scale:.3g} outside sanity rail "
                f"[{lo:g}, {hi:g}] — the time model no longer tracks this "
                f"machine at all")
        for name, meas, pred in ratios:
            norm = meas / max(scale * pred, 1e-9)
            bad = not (1.0 / band <= norm <= band)
            if bad:
                failures.append(
                    f"{name}: wall clock {meas:.1f}us vs predicted "
                    f"{scale * pred:.1f}us (normalized x{norm:.2f}, band "
                    f"{band:g}x)")
            lines.append(
                f"| {name} | wall_clock_us | {scale * pred:.1f} | "
                f"{meas:.1f} | x{norm:.2f} | {'FAIL' if bad else 'ok'} |")
        lines.append(f"| (all) | machine scale | 1.0 | {scale:.3g} | — | "
                     f"{'ok' if lo <= scale <= hi else 'FAIL'} |")
    return failures, lines
