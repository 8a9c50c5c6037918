#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py [--json PATH]

It imports nothing of JAX or of the JAX package, and it fails (exit code
1, no result line) when there is no CUDA device, when it runs without the
repository around it, or when any phase fails.  Phases:

1. Build the three kernel sources from ``src/repro_torch/kernels/csrc``
   (``vsmm.cu``, ``vsconv.cu``, ``vsconv_dw.cu``; one nvcc per source,
   started together) and print their register use.
2. Kernel phase.  Each kernel against its plain version on the card,
   within a relative error of 1e-5 of max|y|, each case without and with
   the fused epilogue (bias + residual + ReLU), then timed (see below).
   One JSON line per case.  Batch 8, 224 px geometries:
   - halo conv: the ResNet-18 layers (stem 7x7/s2 vk 8; 3x3/s1 at 56;
     3x3/s2 64->128; 3x3 512->512 at Hout 7) and one Hout < 4 conv
     (layer4 at 32 px); vsmm: the 1x1/s2 projection and the FC head;
   - depthwise halo: MobileNetV1's dw1 (112, C 32), dw2 (112 -> 56, C 64),
     dw7 (14, C 512), dw12 (14 -> 7, C 512), dw13 (7, C 1024);
   - stack conv: the ResNet-18 stem 7x7/s2, a 3x3/s1 at 56, a 3x3/s2
     64->128 and the MobileNetV1 stem 3x3/s2 cin 3 -> 8;
   - one grouped 3x3 (64 -> 64, groups 4, 56 px) through the halo and the
     stack kernel;
   - depthwise stack: dw1 and dw12.
3. Serve phases, one per path.  Before each, every launch count is set
   to 0; the port's ``CNNServer(cfg, batch=8, impl=...)`` serves seeded
   224x224x3 requests; the counts are read just after and must be exactly
   the path's per-wave launches times the waves:
   - ResNet-18, halo (16 requests): 17 vsconv_halo + 4 vsmm per wave;
   - MobileNetV1, halo (16 requests):
     1 vsconv_halo + 13 vsconv_dw_halo + 14 vsmm per wave;
   - MobileNetV1, stack (8 requests, one wave): 1 vsconv_stack +
     13 vsconv_dw_stack + 14 vsmm;
   - ResNet-18, stack (8 requests, one wave): 17 vsconv_stack + 4 vsmm.
   Every request must be delivered, finite, and equal to a direct
   ``net_apply(impl="plain")`` on the card within 1e-5.  The two halo
   paths then serve their traffic again, warm: images/s and ms per wave.
4. Profile.  One more warm serve of each halo path under
   `torch.profiler`: the device's busy time and idle share over that
   serve, and device time by kind.  The busy time over the unprofiled warm
   serve's wall clock is printed too, named as the estimate from two
   serves that it is.
5. Per-forward breakdown.  Every sparse layer of one batch-8 forward of
   each halo path, and every layer that runs a stack kernel in each stack
   path, is re-run at its real input (collected from the forward; the
   residual is a seeded tensor of the right shape): kernel, plain version
   and the PyTorch library call (cuDNN conv — ``groups=C`` on the
   densified depthwise weight for the depthwise layers — or cuBLAS matmul
   on the densified weight, TF32 off, bias included, residual and ReLU
   not) are timed and checked.  The ``kernels`` line sums these per
   kernel over the layers timed above (a stack path's vsmm layers are its
   halo path's, timed once): ``ms``, ``plain_ms``, ``library_ms`` and
   ``bound_ms`` are per forward at batch 8 (the JSON file keeps the sums
   per path), ``launches`` the counts of the serve phases summed over the
   paths (per path in ``launches_by_path``).

``kernel_ms``, ``plain_ms`` and ``library_ms`` are device time per call:
a run of calls is captured in one CUDA graph and its replays are timed
with CUDA events, so the host's launch overhead is not in them (the
device's gap between back-to-back launches is).  ``kernel_host_loop_ms``
is the CUDA event time of a host loop of kernel calls, launch overhead
included.  A stack kernel's time does not include building its stack.
Timings do not flush L2 between launches.

``bound_ms`` is max(FLOPs / fp32 CUDA-core peak, bytes / HBM bandwidth),
with the peaks of the SKU nvidia-smi names (NVIDIA's datasheet).  Both
count the real function: FLOPs those of the stored tiles this run's
weights hold (2 * pixels * vc * S per strip for a depthwise conv), bytes
the unpadded NHWC input, the stored tiles, bias and residual read once and
the output written once; the stems' zero-padded input channels (3 -> 8)
and the FC heads' padding columns (1000 -> 1024) are left out of both.
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
DENSITY = 0.235          # ResNet-18's pruning point
DW_DENSITY = 0.5         # MobileNetV1's


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
    accumulates sums per kernel and per (path, kernel)."""

    def __init__(self, peak_flops: float, peak_bw: float):
        self.peak_flops, self.peak_bw = peak_flops, peak_bw
        self.sums: dict = {}
        self.by_path: dict = {}
        self.max_abs_err: dict = {}

    def run(self, label: str, kernel: str, fk, fp, flib, flops: int,
            nbytes: int, reps: int = 20, **extra) -> dict:
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
            "max_abs_err": err, **extra,
        }
        row["bound_ms"] = max(row["flops_bound_ms"], row["bytes_bound_ms"])
        self.max_abs_err[kernel] = max(self.max_abs_err.get(kernel, 0.0), err)
        print(json.dumps(row), flush=True)
        return row

    def add(self, path: str, row: dict) -> None:
        for table in (self.sums, self.by_path.setdefault(path, {})):
            s = table.setdefault(row["kernel"], {
                "ms": 0.0, "host_loop_ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "flops_bound_ms": 0.0,
                "bytes_bound_ms": 0.0, "layers": 0})
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
    port's sparsify does (cin-major for kh > 1).  ``cin`` is the channels
    per group of a grouped conv; a depthwise tap matrix is ``cin=1, vk=1``
    (taps stay in ascending order)."""
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
    return conv_cin_major(vs, cin // vk) if kh > 1 and vk > 1 else vs


def _conv_case(timer: Timer, label: str, x, vs, *, kh: int, stride: int,
               cin_real: int, groups: int = 1, layout: str = "halo",
               bias=None, residual=None, relu: bool = False,
               reps: int = 20) -> dict:
    """Time a full conv kernel (``layout`` "halo" or "stack") on NHWC ``x``
    against its plain version and cuDNN on the densified weight.  ``x`` may
    carry zero padding channels beyond ``cin_real``; the bound counts only
    the real ones."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.sparse_ops import same_pads
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels import vsconv as K

    n, h, w, c = x.shape
    ho, pt, pb = same_pads(h, kh, stride)
    wo, pl, pr = same_pads(w, kh, stride)
    if layout == "halo":
        buf = K.build_halo_input(x, kh=kh, kw=kh, stride=stride, vk=vs.vk)
        kernel, plain, name = (K.vsconv_halo_kernel, K.vsconv_plain,
                               "vsconv_halo")
    else:
        buf = K.build_row_tap_stack(x, kh=kh, kw=kh, stride=stride)
        kernel, plain, name = (K.vsconv_stack_kernel, K.vsconv_stack_plain,
                               "vsconv_stack")
    kw = dict(w_out=wo, kh=kh, kw=kh, stride=stride, groups=groups,
              bias=bias, residual=residual, fuse_relu=relu)
    x_lib = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    w_lib = decode(vs).reshape(kh, kh, c // groups, -1).permute(3, 2, 0, 1) \
        .contiguous(memory_format=torch.channels_last)
    out_numel = n * ho * wo * vs.shape[1]
    real = cin_real / c  # the padding channels' share of every stored tile
    return timer.run(
        label, name,
        lambda: kernel(buf, vs, **kw),
        lambda: plain(buf, vs, **kw),
        lambda: F.conv2d(x_lib, w_lib, bias, stride, groups=groups),
        flops=round(2 * n * ho * wo * vs.vals.numel() * real),
        nbytes=4 * n * h * w * cin_real + round(_nbytes(vs.vals) * real)
        + _nbytes(vs.idx, bias, residual) + 4 * out_numel,
        reps=reps, buffer_bytes=_nbytes(buf))


def _dw_case(timer: Timer, label: str, x, vs, *, stride: int,
             layout: str = "halo", bias=None, residual=None,
             relu: bool = False, reps: int = 20) -> dict:
    """Time a 3x3 depthwise kernel (``layout`` "halo" or "stack") on NHWC
    ``x`` against its plain version and cuDNN's depthwise conv
    (``groups=C``) on the densified tap matrix."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.sparse_ops import same_pads
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels import vsconv as K
    from repro_torch.kernels import vsconv_dw as D

    n, h, w, c = x.shape
    ho, pt, pb = same_pads(h, 3, stride)
    wo, pl, pr = same_pads(w, 3, stride)
    if layout == "halo":
        buf = K.build_halo_input(x, kh=3, kw=3, stride=stride, vk=vs.vn)
        kernel, plain, name = (D.vsconv_dw_halo_kernel, D.vsconv_dw_plain,
                               "vsconv_dw_halo")
    else:
        buf = K.build_row_tap_stack(x, kh=3, kw=3, stride=stride)
        kernel, plain, name = (D.vsconv_dw_stack_kernel,
                               D.vsconv_dw_stack_plain, "vsconv_dw_stack")
    kw = dict(w_out=wo, kh=3, kw=3, stride=stride, bias=bias,
              residual=residual, fuse_relu=relu)
    x_lib = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    w_lib = decode(vs).reshape(3, 3, 1, c).permute(3, 2, 0, 1) \
        .contiguous(memory_format=torch.channels_last)
    return timer.run(
        label, name,
        lambda: kernel(buf, vs, **kw),
        lambda: plain(buf, vs, **kw),
        lambda: F.conv2d(x_lib, w_lib, bias, stride, groups=c),
        flops=2 * n * ho * wo * vs.vals.numel(),
        nbytes=_nbytes(x, vs.vals, vs.idx, bias, residual)
        + 4 * n * ho * wo * c,
        reps=reps, buffer_bytes=_nbytes(buf))


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
    """Each kernel at the main paths' geometries, without and with the
    epilogue."""
    import torch
    gen = torch.Generator().manual_seed(0)

    def act(*shape, zero_channels: int = 0):
        x = torch.relu(torch.randn(*shape, generator=gen))
        if zero_channels:
            x[..., -zero_channels:] = 0  # a stem's cin padding 3 -> 8
        return x.to(dev)

    def epilogue(n, ho, cout):
        return dict(bias=torch.randn(cout, generator=gen).to(dev),
                    residual=torch.randn(n, ho, ho, cout, generator=gen
                                         ).to(dev), relu=True)

    conv_cases = [  # label, H, cin, cout, kh, stride, vk, vn, density,
        #             groups, layouts
        ("stem 7x7/s2 224px cin 3->8", 224, 8, 64, 7, 2, 8, 64, 1.0, 1,
         ("halo", "stack")),
        ("3x3/s1 56px 64->64", 56, 64, 64, 3, 1, 32, 64, DENSITY, 1,
         ("halo", "stack")),
        ("3x3/s2 56px 64->128", 56, 64, 128, 3, 2, 32, 128, DENSITY, 1,
         ("halo", "stack")),
        ("3x3/s1 7px 512->512", 7, 512, 512, 3, 1, 32, 128, DENSITY, 1,
         ("halo",)),
        ("3x3/s1 1px 512->512 (32px layer4, Hout<4)", 1, 512, 512, 3, 1, 32,
         128, DENSITY, 1, ("halo",)),
        ("MobileNetV1 stem 3x3/s2 224px cin 3->8 ->32", 224, 8, 32, 3, 2, 8,
         32, 1.0, 1, ("stack",)),
        ("grouped 3x3/s1 56px 64->64 groups 4", 56, 64, 64, 3, 1, 16, 16,
         DW_DENSITY, 4, ("halo", "stack")),
    ]
    for (label, h, cin, cout, kh, s, vk, vn, d, groups,
         layouts) in conv_cases:
        vs = _sparse_weight(gen, kh, cin // groups, cout, vk, vn, d, dev)
        zc = 5 if cin == 8 else 0
        x = act(BATCH, h, h, cin, zero_channels=zc)
        ho = -(-h // s)
        epi = epilogue(BATCH, ho, cout)
        for layout in layouts:
            kw = dict(kh=kh, stride=s, cin_real=cin - zc, groups=groups,
                      layout=layout)
            _conv_case(timer, f"{layout} {label}", x, vs, **kw)
            _conv_case(timer, f"{layout} {label} +bias+residual+relu", x, vs,
                       **kw, **epi)
    dw_cases = [  # label, H, C, stride, layouts (MobileNetV1 at 224 px)
        ("dw1 112px C32 s1", 112, 32, 1, ("halo", "stack")),
        ("dw2 112->56px C64 s2", 112, 64, 2, ("halo",)),
        ("dw7 14px C512 s1", 14, 512, 1, ("halo",)),
        ("dw12 14->7px C512 s2", 14, 512, 2, ("halo", "stack")),
        ("dw13 7px C1024 s1", 7, 1024, 1, ("halo",)),
    ]
    for label, h, c, s, layouts in dw_cases:
        vs = _sparse_weight(gen, 3, 1, c, 1, min(c, 128), DW_DENSITY, dev)
        x = act(BATCH, h, h, c)
        epi = epilogue(BATCH, -(-h // s), c)
        for layout in layouts:
            _dw_case(timer, f"{layout} {label}", x, vs, stride=s,
                     layout=layout)
            _dw_case(timer, f"{layout} {label} +bias+residual+relu", x, vs,
                     stride=s, layout=layout, **epi)
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


def _counters() -> dict:
    """The launch counter of every kernel wrapper, by kernel name."""
    from repro_torch.kernels.vsconv import (vsconv_halo_kernel,
                                            vsconv_stack_kernel)
    from repro_torch.kernels.vsconv_dw import (vsconv_dw_halo_kernel,
                                               vsconv_dw_stack_kernel)
    from repro_torch.kernels.vsmm import vsmm_kernel
    return {"vsconv_halo": vsconv_halo_kernel, "vsmm": vsmm_kernel,
            "vsconv_dw_halo": vsconv_dw_halo_kernel,
            "vsconv_stack": vsconv_stack_kernel,
            "vsconv_dw_stack": vsconv_dw_stack_kernel}


# path -> (config, impl, requests, launches per wave, warm re-serve)
PATHS = {
    "resnet18-halo": ("vscnn-resnet18", "auto", 16,
                      {"vsconv_halo": 17, "vsmm": 4}, True),
    "mobilenet_v1-halo": ("vscnn-mobilenet-v1", "auto", 16,
                          {"vsconv_halo": 1, "vsconv_dw_halo": 13,
                           "vsmm": 14}, True),
    "mobilenet_v1-stack": ("vscnn-mobilenet-v1", "pallas-stack", BATCH,
                           {"vsconv_stack": 1, "vsconv_dw_stack": 13,
                            "vsmm": 14}, False),
    "resnet18-stack": ("vscnn-resnet18", "pallas-stack", BATCH,
                       {"vsconv_stack": 17, "vsmm": 4}, False),
}


def serve_phase(path: str, dev) -> dict:
    """One path: the port's CNN server answering seeded requests, with
    every kernel's launch count set to 0 just before and read just
    after."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CNNServer, ImageRequest
    from repro_torch.models.graph import net_apply

    name, impl, n_req, per_wave, warm = PATHS[path]
    cfg = get_config(name)
    t0 = time.perf_counter()
    srv = CNNServer(cfg, batch=BATCH, impl=impl, seed=0, device=dev)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(n_req)]

    def requests():
        return [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]

    reqs = requests()
    counters = _counters()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    stats = srv.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in counters.items() if k.launches}

    waves = sum(s["steps"] for s in stats)
    delivered = [r for r in reqs if r.outcome is not None
                 and r.outcome.status == "delivered"]
    if len(delivered) != n_req:
        raise SystemExit(f"chip_smoke: {path}: {len(delivered)}/{n_req} "
                         f"delivered")
    expected = {k: v * waves for k, v in per_wave.items()}
    if launches != expected:
        raise SystemExit(f"chip_smoke: {path}: launches {launches} over "
                         f"{waves} waves, expected {per_wave} per wave")
    served = np.stack([r.logits for r in reqs])
    if served.shape != (n_req, cfg.num_classes) or \
            not np.isfinite(served).all():
        raise SystemExit(f"chip_smoke: {path}: served logits {served.shape} "
                         f"not finite or of the wrong shape")
    with torch.inference_mode():
        ref = torch.cat([
            net_apply(srv.net, srv.params,
                      torch.from_numpy(np.stack(images[i:i + BATCH])).to(dev),
                      sparse=srv.sparse, impl="plain")
            for i in range(0, n_req, BATCH)]).cpu()
    rel, _ = _rel_err(torch.from_numpy(served), ref)
    if not rel <= RTOL:
        raise SystemExit(f"chip_smoke: {path}: served vs plain net_apply "
                         f"relative error {rel:.3e} > {RTOL}")
    out = {
        "phase": "serve", "path": path, "config": cfg.name, "impl": impl,
        "batch": BATCH, "requests": n_req, "delivered": len(delivered),
        "waves": waves, "launches": launches, "setup_s": setup_s,
        "first_serve_s": serve_s, "first_images_per_s": n_req / serve_s,
        "served_vs_plain_rel_err": rel,
    }
    warm_s = None
    if warm:
        # the same traffic again, now warm: steady-state rate
        t0 = time.perf_counter()
        stats2 = srv.serve(requests())
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        out.update(
            warm_serve_s=warm_s, warm_images_per_s=n_req / warm_s,
            warm_ms_per_wave=1e3 * sum(s["run_s"] for s in stats2)
            / sum(s["steps"] for s in stats2))
    print(json.dumps(out), flush=True)
    return {"srv": srv, "images": images, "launches": launches,
            "warm_s": warm_s, "summary": out}


def _kind(name: str) -> str:
    for kind in ("vsconv_dw_halo", "vsconv_dw_stack", "vsconv_halo",
                 "vsconv_stack", "vsmm"):
        if f"{kind}_kernel" in name:
            return kind
    if "Memcpy" in name or "Memset" in name:
        return "copy"
    return "other"


def profile_phase(path: str, srv, images, warm_s: float) -> dict:
    """One more warm serve of the path's requests under `torch.profiler`:
    the device's busy time (the union of its kernel and copy intervals)
    against the wall clock of the same serve, and device time by kind.  The
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
        kind = _kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (end - start) / 1e3
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    out = {"phase": "profile", "path": path, "wall_ms": wall_ms,
           "device_events": len(spans),
           "device_busy_ms": busy_us / 1e3 if spans else None,
           "device_idle_share": 1 - busy_us / 1e3 / wall_ms if spans
           else None,
           "idle_share_est_two_serves": 1 - busy_us / 1e3 / (warm_s * 1e3)
           if spans else None,
           "device_ms_by_kind": by_kind}
    print(json.dumps(out), flush=True)
    return out


def forward_phase(timer: Timer, path: str, srv, images, dev, *,
                  stack_layers_only: bool = False) -> None:
    """Every sparse layer of one batch-8 forward of the path at its real
    input (``stack_layers_only``: only the layers that run a stack
    kernel; the rest are the halo path's)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.models.graph import Conv, FC, net_apply

    gen = torch.Generator().manual_seed(1)
    layout = "stack" if srv.backend.apply.impl == "pallas-stack" else "halo"
    x = torch.from_numpy(np.stack(images[:BATCH])).to(dev)
    rec: list = []
    with torch.inference_mode():
        net_apply(srv.net, srv.params, x, sparse=srv.sparse,
                  impl=srv.backend.apply.impl, collect=rec)
    inputs = {name: xin for name, xin, *_ in rec}
    for l in srv.net.layers:
        if not isinstance(l, (Conv, FC)):
            continue
        pointwise = isinstance(l, FC) or (l.kh == 1 and l.kw == 1)
        if stack_layers_only and pointwise:
            continue
        label = f"forward {path} {l.name}"
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
            if pointwise:
                xs = xin[:, ::l.stride, ::l.stride].reshape(-1, xin.shape[3])
                row = _mm_case(timer, label, xs.contiguous(), spec.vs,
                               n_real=l.cout, bias=spec.bias, relu=l.relu,
                               residual=None if res is None
                               else res.reshape(-1, l.cout))
            elif l.groups == l.cin and l.groups > 1:
                row = _dw_case(timer, label, xin, spec.vs, stride=l.stride,
                               layout=layout, bias=spec.bias, residual=res,
                               relu=l.relu)
            else:
                row = _conv_case(timer, label, xin, spec.vs, kh=l.kh,
                                 stride=l.stride, cin_real=cin_real,
                                 groups=l.groups, layout=layout,
                                 bias=spec.bias, residual=res, relu=l.relu)
        else:
            spec = srv.sparse[l.name]
            n_enc = spec.vs.shape[1]
            bias = F.pad(spec.bias, (0, n_enc - spec.bias.shape[0]))
            # the GAP output: dense, non-negative, one row per image
            xin = torch.rand(BATCH, l.din, generator=gen).to(dev)
            row = _mm_case(timer, label, xin, spec.vs,
                           n_real=spec.bias.shape[0], bias=bias, relu=l.relu)
        timer.add(path, row)


# kernel -> (CUDA source, the Pallas function it replaces)
SOURCES = {
    "vsconv_halo": ("src/repro_torch/kernels/csrc/vsconv.cu",
                    "src/repro/kernels/vsconv.py:623"),
    "vsmm": ("src/repro_torch/kernels/csrc/vsmm.cu",
             "src/repro/kernels/vsmm.py:172"),
    "vsconv_dw_halo": ("src/repro_torch/kernels/csrc/vsconv_dw.cu",
                       "src/repro/kernels/vsconv.py:1020"),
    "vsconv_stack": ("src/repro_torch/kernels/csrc/vsconv.cu",
                     "src/repro/kernels/vsconv.py:833"),
    "vsconv_dw_stack": ("src/repro_torch/kernels/csrc/vsconv_dw.cu",
                        "src/repro/kernels/vsconv.py:1162"),
}


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
    logs = _build.build("vsmm", "vsconv", "vsconv_dw")
    build_s = time.perf_counter() - t0
    for kernel, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {kernel}: {'; '.join(regs)}")
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "built": sorted(logs)}), flush=True)

    timer = Timer(peak_flops, peak_bw)
    kernel_phase(timer, dev)
    served = {path: serve_phase(path, dev) for path in PATHS}
    profiled = {path: profile_phase(path, s["srv"], s["images"], s["warm_s"])
                for path, s in served.items() if s["warm_s"] is not None}
    for path, s in served.items():
        forward_phase(timer, path, s["srv"], s["images"], dev,
                      stack_layers_only=path.endswith("-stack"))

    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        s = timer.sums[kname]
        by_path = {path: v["launches"][kname] for path, v in served.items()
                   if kname in v["launches"]}
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": timer.max_abs_err[kname], "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": max(s["flops_bound_ms"], s["bytes_bound_ms"]),
            "bound_by": ("operations" if s["flops_bound_ms"]
                         >= s["bytes_bound_ms"] else "bytes"),
            "library_ms": s["library_ms"],
        })
    result = {"kernels": kernels}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"gpu": smi, "result": result, "per_forward": timer.sums,
             "per_forward_by_path": timer.by_path,
             "serve": {p: s["summary"] for p, s in served.items()},
             "profile": profiled}, indent=1))
    print(smi)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
