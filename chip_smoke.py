#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py [--json PATH]

It imports nothing of JAX or of the JAX package, and it fails (exit code
1, no result line) when there is no CUDA device, when it runs without the
repository around it, or when any phase fails.  Phases:

1. Build both kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, started together) and print their register use.
2. Kernel phase.  Each kernel at the ResNet-18 224 px, batch-8 geometries
   (stem 7x7/s2 vk 8; 3x3/s1 at 56; 3x3/s2 64->128; 3x3 512->512 at Hout 7;
   the 1x1/s2 projection and the FC head through vsmm) plus one Hout < 4
   conv (layer4 at 32 px), each without and with the fused epilogue
   (bias + residual + ReLU): kernel vs plain version on the card within a
   relative error of 1e-5 of max|y|, then timed (see below).  One JSON line
   per case.
3. Serve phase, the main path.  The launch counts are set to 0, the port's
   ``CNNServer(vscnn-resnet18, batch=8)`` serves 16 seeded 224x224x3
   requests, and the counts are read: each wave must launch the conv kernel
   17 times and vsmm 4 times.  All 16 must be delivered, finite, and equal
   to a direct ``net_apply(impl="plain")`` on the card within 1e-5.
4. Profile.  One more warm serve under `torch.profiler`: the device's
   busy time and idle share over that serve, and device time by kind.  The
   busy time over the unprofiled warm serve's wall clock is printed too,
   named as the estimate from two serves that it is.
5. Per-forward breakdown.  Every sparse layer of one batch-8 forward is
   re-run at its real input (collected from the forward; the residual is a
   seeded tensor of the right shape): kernel, plain version and the PyTorch
   library call (cuDNN conv / cuBLAS matmul on the densified weight, TF32
   off, bias included, residual and ReLU not) are timed and checked.  The
   ``kernels`` line sums these per kernel: ``ms``, ``plain_ms``,
   ``library_ms`` and ``bound_ms`` are per forward at batch 8.

``kernel_ms``, ``plain_ms`` and ``library_ms`` are device time per call:
a run of calls is captured in one CUDA graph and its replays are timed
with CUDA events, so the host's launch overhead is not in them (the
device's gap between back-to-back launches is).  ``kernel_host_loop_ms``
is the CUDA event time of a host loop of kernel calls, launch overhead
included.
Timings do not flush L2 between launches.

``bound_ms`` is max(FLOPs / fp32 CUDA-core peak, bytes / HBM bandwidth),
with the peaks of the SKU nvidia-smi names (NVIDIA's datasheet).  Both
count the real function: FLOPs those of the stored tiles this run's
weights hold, bytes the unpadded NHWC input, the stored tiles, bias and
residual read once and the output written once; the stem's zero-padded
input channels (3 -> 8) and the FC head's padding columns (1000 -> 1024)
are left out of both.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# fp32 CUDA-core FLOP/s (no tensor cores) and HBM bytes/s per SKU, from
# NVIDIA's datasheets; matched against the name nvidia-smi gives.
PEAKS = (
    ("H100 NVL", 60e12, 3.9e12),
    ("H100 PCIe", 51e12, 2.0e12),
    ("H100", 67e12, 3.35e12),   # H100 SXM5 80GB HBM3
    ("H200", 67e12, 4.8e12),
)
RTOL = 1e-5
BATCH = 8
SIZE = 224
DENSITY = 0.235


def _peaks(name: str) -> tuple[float, float]:
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    raise SystemExit(f"chip_smoke: no datasheet peaks for {name!r}")


def _time_ms(fn, reps: int) -> float:
    """CUDA event time per call of a host loop of ``reps`` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, replays: int = 3) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    ``replays`` replays of it timed with CUDA events, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def _rel_err(y, ref) -> tuple[float, float]:
    """(max|y - ref| / max|ref|, max|y - ref|)."""
    d = float((y.double() - ref.double()).abs().max())
    return d / max(float(ref.double().abs().max()), 1e-30), d


def _check(label: str, y, ref) -> float:
    rel, abs_err = _rel_err(y, ref)
    if not rel <= RTOL:
        raise SystemExit(f"chip_smoke: {label}: kernel vs plain relative "
                         f"error {rel:.3e} > {RTOL}")
    return abs_err


class Timer:
    """Times one layer's kernel, plain version and library call, and
    accumulates per-kernel sums."""

    def __init__(self, peak_flops: float, peak_bw: float):
        self.peak_flops, self.peak_bw = peak_flops, peak_bw
        self.sums: dict = {}
        self.max_abs_err: dict = {}

    def run(self, label: str, kernel: str, fk, fp, flib, flops: int,
            nbytes: int, reps: int = 20) -> dict:
        import torch
        y_k = fk()
        y_p = fp()
        torch.cuda.synchronize()
        err = _check(label, y_k, y_p)
        row = {
            "case": label, "kernel": kernel,
            "kernel_ms": _device_ms(fk, reps),
            "kernel_host_loop_ms": _time_ms(fk, reps),
            "plain_ms": _device_ms(fp, max(2, reps // 4)),
            "library_ms": None if flib is None else _device_ms(flib, reps),
            "flops": flops, "bytes": nbytes,
            "flops_bound_ms": flops / self.peak_flops * 1e3,
            "bytes_bound_ms": nbytes / self.peak_bw * 1e3,
            "max_abs_err": err,
        }
        row["bound_ms"] = max(row["flops_bound_ms"], row["bytes_bound_ms"])
        self.max_abs_err[kernel] = max(self.max_abs_err.get(kernel, 0.0), err)
        print(json.dumps(row), flush=True)
        return row

    def add(self, row: dict) -> None:
        s = self.sums.setdefault(row["kernel"], {
            "ms": 0.0, "host_loop_ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "flops_bound_ms": 0.0, "bytes_bound_ms": 0.0,
            "layers": 0})
        s["host_loop_ms"] += row["kernel_host_loop_ms"]
        for k in ("flops_bound_ms", "bytes_bound_ms", "plain_ms",
                  "library_ms"):
            s[k] += row[k]
        s["ms"] += row["kernel_ms"]
        s["layers"] += 1


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _sparse_weight(gen, kh: int, cin: int, cout: int, vk: int, vn: int,
                   density: float, device):
    """A seeded (kh*kh*cin, cout) weight, balanced-pruned and encoded as the
    port's sparsify does (cin-major for kh > 1)."""
    import torch
    from repro_torch.core.pruning import prune_vectors_balanced
    from repro_torch.core.vector_sparse import conv_cin_major, from_mask

    w = (torch.randn(kh * kh * cin, cout, generator=gen)
         * (kh * kh * cin) ** -0.5).numpy()
    if density < 1.0:
        w, mask = prune_vectors_balanced(w, density, vk, vn)
    else:
        mask = torch.ones(w.shape[0] // vk, cout // vn, dtype=torch.bool
                          ).numpy()
    vs = from_mask(torch.as_tensor(w, device=device), mask, vk, vn)
    return conv_cin_major(vs, cin // vk) if kh > 1 else vs


def _conv_case(timer: Timer, label: str, x, vs, *, kh: int, stride: int,
               cin_real: int, bias=None, residual=None, relu: bool = False,
               reps: int = 20) -> dict:
    """Time the halo conv kernel on NHWC ``x`` against its plain version
    and cuDNN on the densified weight.  ``x`` may carry zero padding
    channels beyond ``cin_real``; the bound counts only the real ones."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.sparse_ops import same_pads
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels.vsconv import (build_halo_input,
                                            vsconv_halo_kernel, vsconv_plain)

    n, h, w, c = x.shape
    ho, pt, pb = same_pads(h, kh, stride)
    wo, pl, pr = same_pads(w, kh, stride)
    xh = build_halo_input(x, kh=kh, kw=kh, stride=stride, vk=vs.vk)
    kw = dict(w_out=wo, kh=kh, kw=kh, stride=stride, bias=bias,
              residual=residual, fuse_relu=relu)
    x_lib = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    w_lib = decode(vs).reshape(kh, kh, c, -1).permute(3, 2, 0, 1) \
        .contiguous(memory_format=torch.channels_last)
    out_numel = n * ho * wo * vs.shape[1]
    real = cin_real / c  # the padding channels' share of every stored tile
    return timer.run(
        label, "vsconv_halo",
        lambda: vsconv_halo_kernel(xh, vs, **kw),
        lambda: vsconv_plain(xh, vs, **kw),
        lambda: F.conv2d(x_lib, w_lib, bias, stride),
        flops=round(2 * n * ho * wo * vs.vals.numel() * real),
        nbytes=4 * n * h * w * cin_real + round(_nbytes(vs.vals) * real)
        + _nbytes(vs.idx, bias, residual) + 4 * out_numel,
        reps=reps)


def _mm_case(timer: Timer, label: str, x, vs, *, n_real: int, bias=None,
             residual=None, relu: bool = False, reps: int = 20) -> dict:
    """Time vsmm on (M, K) ``x`` against its plain version and cuBLAS on the
    densified weight.  Output columns past ``n_real`` are the zero padding
    of a remainder strip; the bound counts only the real ones."""
    import torch
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels.vsmm import vsmm_kernel, vsmm_plain

    kw = dict(bias=bias, residual=residual, fuse_relu=relu)
    w_lib = decode(vs)
    lib = ((lambda: torch.addmm(bias, x, w_lib)) if bias is not None
           else (lambda: torch.mm(x, w_lib)))
    m, n_enc = x.shape[0], vs.shape[1]
    real = n_real / n_enc  # balanced pruning: every strip holds S tiles
    return timer.run(
        label, "vsmm",
        lambda: vsmm_kernel(x, vs, **kw),
        lambda: vsmm_plain(x, vs, **kw),
        lib,
        flops=round(2 * m * vs.vals.numel() * real),
        nbytes=_nbytes(x, vs.idx) + round(_nbytes(vs.vals) * real)
        + round(_nbytes(bias, residual) * real) + 4 * m * n_real,
        reps=reps)


def kernel_phase(timer: Timer, dev) -> None:
    """Each kernel at the main path's geometries, without and with the
    epilogue."""
    import torch
    gen = torch.Generator().manual_seed(0)

    def act(*shape, zero_channels: int = 0):
        x = torch.relu(torch.randn(*shape, generator=gen))
        if zero_channels:
            x[..., -zero_channels:] = 0  # the stem's cin padding 3 -> 8
        return x.to(dev)

    conv_cases = [  # label, H, cin, cout, kh, stride, vk, vn, density, batch
        ("stem 7x7/s2 224px cin 3->8", 224, 8, 64, 7, 2, 8, 64, 1.0, BATCH),
        ("3x3/s1 56px 64->64", 56, 64, 64, 3, 1, 32, 64, DENSITY, BATCH),
        ("3x3/s2 56px 64->128", 56, 64, 128, 3, 2, 32, 128, DENSITY, BATCH),
        ("3x3/s1 7px 512->512", 7, 512, 512, 3, 1, 32, 128, DENSITY, BATCH),
        ("3x3/s1 1px 512->512 (32px layer4, Hout<4)", 1, 512, 512, 3, 1, 32,
         128, DENSITY, BATCH),
    ]
    for label, h, cin, cout, kh, s, vk, vn, d, n in conv_cases:
        vs = _sparse_weight(gen, kh, cin, cout, vk, vn, d, dev)
        zc = 5 if cin == 8 else 0
        x = act(n, h, h, cin, zero_channels=zc)
        ho = -(-h // s)
        _conv_case(timer, label, x, vs, kh=kh, stride=s, cin_real=cin - zc)
        _conv_case(
            timer, label + " +bias+residual+relu", x, vs, kh=kh, stride=s,
            cin_real=cin - zc,
            bias=torch.randn(cout, generator=gen).to(dev),
            residual=torch.randn(n, ho, ho, cout, generator=gen).to(dev),
            relu=True)
    mm_cases = [  # label, M, K, N (encoded), N (real), vk, vn
        ("1x1/s2 projection 56px 64->128", BATCH * 28 * 28, 64, 128, 128, 32,
         128),
        ("FC 512->1000 (1024, NB 8)", BATCH, 512, 1024, 1000, 32, 128),
    ]
    for label, m, k, n_out, n_real, vk, vn in mm_cases:
        vs = _sparse_weight(gen, 1, k, n_out, vk, vn, DENSITY, dev)
        x = act(m, k)
        _mm_case(timer, label, x, vs, n_real=n_real)
        _mm_case(
            timer, label + " +bias+residual+relu", x, vs, n_real=n_real,
            bias=torch.randn(n_out, generator=gen).to(dev),
            residual=torch.randn(m, n_out, generator=gen).to(dev), relu=True)


def serve_phase(dev) -> dict:
    """The main path: the port's CNN server answering 16 requests, with the
    kernel launch counts read around it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.vsconv import vsconv_halo_kernel
    from repro_torch.kernels.vsmm import vsmm_kernel
    from repro_torch.launch.serve import CNNServer, ImageRequest
    from repro_torch.models.graph import net_apply

    cfg = get_config("vscnn-resnet18")
    t0 = time.perf_counter()
    srv = CNNServer(cfg, batch=BATCH, seed=0, device=dev)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(16)]

    def requests():
        return [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]

    reqs = requests()
    vsmm_kernel.launches = vsconv_halo_kernel.launches = 0
    t0 = time.perf_counter()
    stats = srv.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"vsconv_halo": vsconv_halo_kernel.launches,
                "vsmm": vsmm_kernel.launches}

    waves = sum(s["steps"] for s in stats)
    delivered = [r for r in reqs if r.outcome is not None
                 and r.outcome.status == "delivered"]
    if len(delivered) != 16:
        raise SystemExit(f"chip_smoke: {len(delivered)}/16 delivered")
    if launches != {"vsconv_halo": 17 * waves, "vsmm": 4 * waves}:
        raise SystemExit(f"chip_smoke: launches {launches} over {waves} "
                         f"waves, expected 17 conv and 4 vsmm per wave")
    served = np.stack([r.logits for r in reqs])
    if served.shape != (16, cfg.num_classes) or not np.isfinite(served).all():
        raise SystemExit(f"chip_smoke: served logits {served.shape} not "
                         f"finite or of the wrong shape")
    with torch.inference_mode():
        ref = torch.cat([
            net_apply(srv.net, srv.params,
                      torch.from_numpy(np.stack(images[i:i + BATCH])).to(dev),
                      sparse=srv.sparse, impl="plain")
            for i in range(0, 16, BATCH)]).cpu()
    rel, _ = _rel_err(torch.from_numpy(served), ref)
    if not rel <= RTOL:
        raise SystemExit(f"chip_smoke: served vs plain net_apply relative "
                         f"error {rel:.3e} > {RTOL}")
    # the same traffic again, now warm: steady-state rate
    t0 = time.perf_counter()
    stats2 = srv.serve(requests())
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    out = {
        "phase": "serve", "config": cfg.name, "batch": BATCH,
        "requests": 16, "delivered": len(delivered), "waves": waves,
        "launches": launches, "setup_s": setup_s,
        "first_serve_s": serve_s, "first_images_per_s": 16 / serve_s,
        "warm_serve_s": warm_s, "warm_images_per_s": 16 / warm_s,
        "warm_ms_per_wave": 1e3 * sum(s["run_s"] for s in stats2)
        / sum(s["steps"] for s in stats2),
        "served_vs_plain_rel_err": rel,
    }
    print(json.dumps(out), flush=True)
    return {"srv": srv, "images": images, "launches": launches,
            "warm_s": warm_s, "summary": out}


def profile_phase(srv, images, warm_s: float) -> dict:
    """One more warm serve of the 16 requests under `torch.profiler`: the
    device's busy time (the union of its kernel and copy intervals) against
    the wall clock of the same serve, and device time by kind.  The
    profiler's own host overhead lengthens the wall clock, so that idle
    share is an upper bound.  The busy time over ``warm_s``, the wall clock
    of the earlier unprofiled serve of the same traffic, is printed as an
    estimate built from two serves.  A trace without device events reports
    nulls (not measured) instead of numbers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import ImageRequest

    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    by_kind: dict = {}
    busy_us, reach = 0.0, float("-inf")
    for start, end, name in spans:
        kind = ("vsconv_halo" if "vsconv_halo_kernel" in name
                else "vsmm" if "vsmm_kernel" in name
                else "copy" if "Memcpy" in name or "Memset" in name
                else "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + (end - start) / 1e3
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    out = {"phase": "profile", "wall_ms": wall_ms,
           "device_events": len(spans),
           "device_busy_ms": busy_us / 1e3 if spans else None,
           "device_idle_share": 1 - busy_us / 1e3 / wall_ms if spans
           else None,
           "idle_share_est_two_serves": 1 - busy_us / 1e3 / (warm_s * 1e3)
           if spans else None,
           "device_ms_by_kind": by_kind}
    print(json.dumps(out), flush=True)
    return out


def forward_phase(timer: Timer, srv, images, dev) -> None:
    """Every sparse layer of one batch-8 forward at its real input."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.models.graph import Conv, FC, net_apply

    gen = torch.Generator().manual_seed(1)
    x = torch.from_numpy(np.stack(images[:BATCH])).to(dev)
    rec: list = []
    with torch.inference_mode():
        net_apply(srv.net, srv.params, x, sparse=srv.sparse, impl="auto",
                  collect=rec)
    inputs = {name: xin for name, xin, *_ in rec}
    for l in srv.net.layers:
        if isinstance(l, Conv):
            spec = srv.sparse[l.name]
            xin = inputs[l.name]
            cin_real = xin.shape[3]
            if spec.cin_pad:
                xin = F.pad(xin, (0, spec.cin_pad))
            ho = -(-xin.shape[1] // l.stride)
            res = None
            if l.residual:
                res = torch.randn(BATCH, ho, ho, l.cout, generator=gen
                                  ).to(dev)
            label = f"forward {l.name}"
            if l.kh == 1 and l.kw == 1:
                xs = xin[:, ::l.stride, ::l.stride].reshape(-1, xin.shape[3])
                row = _mm_case(timer, label, xs.contiguous(), spec.vs,
                               n_real=l.cout, bias=spec.bias, relu=l.relu,
                               residual=None if res is None
                               else res.reshape(-1, l.cout))
            else:
                row = _conv_case(timer, label, xin, spec.vs, kh=l.kh,
                                 stride=l.stride, cin_real=cin_real,
                                 bias=spec.bias,
                                 residual=res, relu=l.relu)
        elif isinstance(l, FC):
            spec = srv.sparse[l.name]
            n_enc = spec.vs.shape[1]
            bias = F.pad(spec.bias, (0, n_enc - spec.bias.shape[0]))
            # the GAP output: dense, non-negative, one row per image
            xin = torch.rand(BATCH, l.din, generator=gen).to(dev)
            row = _mm_case(timer, f"forward {l.name}", xin, spec.vs,
                           n_real=spec.bias.shape[0], bias=bias, relu=l.relu)
        else:
            continue
        timer.add(row)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every result line to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the "
              "GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = _peaks(name)

    t0 = time.perf_counter()
    logs = _build.build("vsmm", "vsconv")
    build_s = time.perf_counter() - t0
    for kernel, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {kernel}: {'; '.join(regs)}")
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "built": sorted(logs)}), flush=True)

    timer = Timer(peak_flops, peak_bw)
    kernel_phase(timer, dev)
    served = serve_phase(dev)
    profiled = profile_phase(served["srv"], served["images"],
                             served["warm_s"])
    forward_phase(timer, served["srv"], served["images"], dev)

    sources = {
        "vsconv_halo": ("src/repro_torch/kernels/csrc/vsconv.cu",
                        "src/repro/kernels/vsconv.py:623"),
        "vsmm": ("src/repro_torch/kernels/csrc/vsmm.cu",
                 "src/repro/kernels/vsmm.py:172"),
    }
    kernels = []
    for kname, (src, replaces) in sources.items():
        s = timer.sums[kname]
        bound = max(s["flops_bound_ms"], s["bytes_bound_ms"])
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": served["launches"][kname],
            "max_abs_err": timer.max_abs_err[kname], "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": bound,
            "bound_by": ("operations" if s["flops_bound_ms"]
                         >= s["bytes_bound_ms"] else "bytes"),
            "library_ms": s["library_ms"],
        })
    result = {"kernels": kernels}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"gpu": smi, "result": result, "per_forward": timer.sums,
             "serve": served["summary"], "profile": profiled}, indent=1))
    print(smi)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
