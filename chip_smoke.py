#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py [--json PATH]

It imports nothing of JAX or of the JAX package, and it fails (exit code
1, no result line) when there is no CUDA device, when it runs without the
repository around it, or when any phase fails.  Phases:

1. Build the four kernel sources from ``src/repro_torch/kernels/csrc``
   (``vsmm.cu``, ``vsconv.cu``, ``vsconv_dw.cu``, ``flash_fwd.cu``; one
   nvcc per source, started together) and print their register use, the
   registers and spill bytes of each flash instantiation (the bf16 hd-128
   one must not spill), of each of the 26 stem-body and depthwise
   instantiations (8 f32 and 8 int8 stem bodies, 10 dw), of the 42 int8
   instantiations (vsmm's 5 phase-1 and 1 phase-2 kernels, the generic
   conv body's 16 phase-1 and 2 phase-2 int8 kernels, the 8 int8 stem
   bodies, 5 dw halo, 5 dw stack), of the 10 vsmm instantiations (f32 and
   int8, both phases) and of the 30 generic conv body instantiations
   (per layout: f32 at 128 and 64 rows x vn 128 and 64 and the general
   one; int8 the same four, split at 64 rows x vn 128 and 64, the general
   one whole and split; phase 2 f32 and int8); none of these may spill),
   and the flash kernel's dynamic shared memory per head dim and body.
2. Kernel phase.  Each kernel against its plain version on the card,
   within a relative error of 1e-5 of max|y| (1e-2 for the flash kernel
   on bf16 inputs), then timed (see below).  One JSON line per case.  The
   CNN kernels at batch 8, 224 px geometries, each case without and with
   the fused epilogue (bias + residual + ReLU):
   - halo conv: the ResNet-18 layers (stem 7x7/s2 vk 8; 3x3/s1 at 56;
     3x3/s2 64->128; 3x3 512->512 at Hout 7) and one Hout < 4 conv
     (layer4 at 32 px); vsmm: the 1x1/s2 projection and the FC head,
     and VGG-16's fc1, MobileNetV1's pw1, pw13 and head (`vsmm_cases`,
     f32 and int8); every vsmm row names its plan (``rows``,
     ``splits``: `vsmm_plan`);
   - depthwise halo: MobileNetV1's dw1 (112, C 32), dw2 (112 -> 56, C 64),
     dw7 (14, C 512), dw12 (14 -> 7, C 512), dw13 (7, C 1024);
   - stack conv: the ResNet-18 stem 7x7/s2, a 3x3/s1 at 56, a 3x3/s2
     64->128;
   - both layouts: the MobileNetV1 stem 3x3/s2 cin 3 -> 8 -> 32, a 7x7/s2
     stem at 227 px (Hout 114, which cuts the stem body's 8 x 16 tiles),
     one grouped 3x3 (64 -> 64, groups 4, 56 px);
   - depthwise stack: dw1, dw2 and dw12.
   The generic conv body (`generic_cases`): VGG-16's conv2 (224 px, vn
   64), conv9 (28 px), conv11 (14 px) and ResNet-18's layer4 (7 px), f32
   and int8 (bit-equal), both layouts, without and with the epilogue.
   Each conv row names its body (``"stem"`` where `use_stem_body` holds,
   else ``"generic"``); a generic row names its plan (``rows``,
   ``splits``: `conv_plan`), and where the plan splits the stored steps
   two launches must give the same bits.
   The int8 branches (`int8_kernel_cases`), each bit-equal to its plain
   version (max|Δ| 0), without and with the epilogue, on int8 tiles and
   activations quantized on the card: the halo and the stack conv at the
   stems (ResNet-18's 7x7/s2, MobileNetV1's 3x3/s2, VGG-16's conv1 and
   7x7/s2 at 227 px, on the int8 stem body), 3x3/s1 at 56, 3x3/s2
   64->128, 3x3 512->512 at Hout 7 and the Hout < 4 case; vsmm at the
   1x1/s2 projection and the FC head; the dw halo and dw stack at dw1,
   dw2, dw12.
   The dense-input mode (`skip_cases`): every kernel and branch (f32 and
   int8 generic and stem bodies in both layouts, at 3x3/s1 56 px and
   VGG-16's conv1; both dw kernels at dw2; vsmm at the 1x1/s2 projection
   and, split, at MobileNetV1's head) with ``skip_zero_inputs=False`` on
   a post-ReLU input whose
   first image is all zero: bit-equal to the skip on, equal to plain,
   both timed (``kernel_ms`` skip off, ``skip_on_ms``).
   The flash kernel (`flash_phase`): Qwen1.5-4B's admission prefill (BH
   160 = 8 x 20 heads, T 512, hd 128, causal) in bf16 and f32, a backfill
   length (T 528), a window of 1024 at T 2048 and hd 240, a q_offset of
   512 (Tq 64 against Tk 576), a bf16 hd-64 case (BH 64, T 1024), a
   non-causal hd 80 case and an odd length (T 33, hd 32).  bf16 runs the
   tensor-core body, f32 the CUDA-core one; each row names its body, and
   two launches of each case must give bit-equal outputs.
3. Serve phases, one per path.  Before each, every launch count is set
   to 0; the port's ``CNNServer(cfg, batch=8, impl=...)`` serves seeded
   224x224x3 requests, every wave by CUDA-graph replay (one graph per
   shape bucket, `BatchedApply`); the counts are read just after.  The
   first wave of a bucket runs its forward twice on the device, an eager
   warm-up and the first replay, and the capture between them runs
   nothing: the counts count what the device ran (`kernels.capture`), so
   they must be exactly the path's per-forward launches times (waves +
   graphs captured), with one graph and one replay a wave:
   - ResNet-18, halo (16 requests): 17 vsconv_halo + 4 vsmm per wave;
   - MobileNetV1, halo (16 requests):
     1 vsconv_halo + 13 vsconv_dw_halo + 14 vsmm per wave;
   - MobileNetV1, stack (8 requests, one wave): 1 vsconv_stack +
     13 vsconv_dw_stack + 14 vsmm;
   - ResNet-18, stack (8 requests, one wave): 17 vsconv_stack + 4 vsmm;
   - ResNet-18, int8 halo (``CNNServer(..., dtype="int8")``, 16
     requests): 17 vsconv_halo + 4 vsmm per wave, all int8 launches;
   - MobileNetV1, int8 halo (16 requests): 1 vsconv_halo + 13
     vsconv_dw_halo + 14 vsmm per wave, all int8 launches;
   - ResNet-18, int8 stack (``CNNServer(..., dtype="int8",
     impl="pallas-stack")``, 8 requests): 17 vsconv_stack + 4 vsmm, all
     int8 launches;
   - MobileNetV1, int8 stack (8 requests): 1 vsconv_stack + 13
     vsconv_dw_stack + 14 vsmm, all int8 launches;
   - VGG-16, halo (``vscnn-vgg16``, 16 requests): 13 vsconv_halo + 3
     vsmm per wave (conv1 on the stem body);
   - VGG-16, int8 stack (8 requests): 13 vsconv_stack + 3 vsmm, all int8
     launches;
   - ResNet-34, halo and int8 halo (16 requests each): 33 vsconv_halo
     (the stem and 32 3x3s) + 4 vsmm (3 projections, the head) per wave;
   - ResNet-50, halo and int8 halo (16 requests each): 17 vsconv_halo
     (the stem and 16 3x3s) + 37 vsmm (32 block 1x1s, every conv3 with
     the shortcut fused, 4 projections, the head) per wave.
   Each path must run the stem body exactly once a wave (the wrappers'
   ``stem_launches``; an int8 path its int8 twin), and every launch of an
   int8 path must be of an int8 branch (``int8_launches``), none of an
   f32 path.
   Every request must be delivered, finite, bit-equal to an eager
   ``net_apply`` with the path's impl on the same batches, and equal to a
   direct ``net_apply(impl="plain")`` on the card within 1e-5 (f32) or
   bit for bit (int8).  Every path then serves its traffic 5 more times,
   warm (no capture, one replay a wave): images/s and ms per wave.
   Partial waves (`bucket_mix_phase`, ResNet-18 halo f32 and int8): with
   the counts at 0 again, 4 requests capture a second bucket (batch 4)
   and 12 requests twice replay 8, 4, 8, 4, so two graphs that share one
   memory pool replay out of their capture order; every wave bit-equal
   to eager ``net_apply``, the counts exactly 6 forwards' (the warm-up and
   5 replays).
4. Profile.  One more warm serve of each path under `torch.profiler`:
   the device's busy time and idle share over that serve, and device time
   by kind.  The busy time over the unprofiled warm serve's wall clock is
   printed too, named as the estimate from two serves that it is.  The
   trace must hold device events, and one of each kernel for each launch
   the serve counted: CUPTI reports the kernels inside graph replays, and
   this is what shows that the replays, whose counts the capture
   recorded, ran them.
5. Per-forward breakdown.  Every sparse layer of one batch-8 forward of
   each halo path, and every layer that runs a stack kernel in each stack
   path (every layer of a stack path without a halo twin), is re-run at
   its real input (collected from the forward, FC inputs too; the
   residual is a seeded tensor of the right shape): kernel, plain version
   and the PyTorch library call (cuDNN conv — ``groups=C`` on the
   densified depthwise weight for the depthwise layers — or cuBLAS matmul
   on the densified weight, TF32 off, bias included, residual and ReLU
   not) are timed and checked.  The ``kernels`` line sums these per
   kernel over the layers timed above (a stack path's vsmm layers are its
   halo twin's, where it has one, timed once): ``ms``, ``plain_ms``,
   ``library_ms`` and ``bound_ms`` are per forward at batch 8 (the JSON
   file keeps the sums per path), ``launches`` the counts of the serve
   phases summed over the paths (per path in ``launches_by_path``; warm-ups
   and replays of the first serve, as the device ran them).  The
   ``vsconv_halo`` and ``vsconv_stack`` entries and their ``_int8`` twins
   carry ``stem_body``: the stem layers' share (launches, ms, plain, bound
   and library ms).
   Then the paper's dense-versus-sparse comparison on VGG-16
   (`dense_vs_sparse_phase`): device ms of a batch-8 forward summed over
   its layers at their real inputs, (a) as served (density 0.235, skip
   on), (b) skip off, (c) density 1.0 on the same kernels, skip off, (d)
   the dense net on cuDNN/cuBLAS f32; printed on one line before the
   card's line.
6. Fleet phase (`fleet_phase`, ResNet-50 f32 halo and int8 halo): two
   replicas on the card (`CNNServer(replicas=2)`) bit-identical to one
   with exact counts per replica, a hand-made dispatch of both replicas
   before either is collected, warm images/s at 1 and 2 replicas in
   alternating pairs with each one's idle share, and four fault runs
   (the seeded ``FaultPlan.random(0, replicas=2)``, a ``nan``, a
   ``die_collect``, a ``stall``) held to one outcome a request and to the
   bounds that the wave's size and members set (see `fleet_phase`).
7. CLI phase (`cli_phase`): ``python -m repro_torch.launch.serve`` run
   as a user runs it, on ResNet-50 with two replicas under chaos seed 0
   and on Qwen1.5-4B (reduced configs); both must exit 0 and print their
   summary.  Every phase's seconds are printed (``"phase": "seconds"``).
8. LM serve phase.  The port's ``Server(get_config("qwen1.5-4b"),
   batch=8, capacity=552)`` with bf16 weights from seed 0 at full depth
   and width (40 layers, d_model 2560, vocab 151936) serves 16 seeded
   requests (12 prompts of 497-512 tokens with max_new 8-32, 4 of 241-256
   tokens with max_new 16), counts zeroed before and read after: every
   request delivered with max_new tokens in [0, padded_vocab), and the
   flash kernel launched exactly 40 x (lockstep runs + backfills).  Then
   the first run's admitted batch is re-run directly: its admission
   prefill's logits through the kernel against the same prefill through
   `flash_fwd_plain` (with f32 weights within 1e-4 of max|logit|; in bf16
   within 2e-2, or within the spread of two other valid attention
   implementations where that is larger), and a greedy ``prefill`` +
   ``decode_step`` loop (no flash launch in its decode steps) must emit
   exactly the tokens the server delivered.  The server decodes by
   replaying one CUDA graph per (batch, capacity), once a step (checked).
   The traffic is served again warm (prefill seconds per run, decode
   tokens/s, ms per decode step).  Then (`lm_decode_phase`) one replayed
   decode step must equal an eager ``decode_step`` from the same caches
   and position bit for bit, and the step is timed at batch 8 (ms per
   served step, device ms per replay, device operations per step).  The
   traffic is served once more under `torch.profiler` (idle share, device
   time by kind: flash kernel, GEMMs, copies, other), and one batch-8,
   T-512 prefill is broken down into the flash kernel's share (per layer
   x 40: device, plain, library and bound ms) and the rest.  The
   ``kernels`` line's flash entry is per such prefill (40 launches);
   ``launches`` is the serve phase's count.

``kernel_ms``, ``plain_ms`` and ``library_ms`` are device time per call:
a run of calls is captured in one CUDA graph and its replays are timed
with CUDA events, so the host's launch overhead is not in them (the
device's gap between back-to-back launches is).  ``kernel_host_loop_ms``
is the CUDA event time of a host loop of kernel calls, launch overhead
included.  A stack kernel's time does not include building its stack.
Timings do not flush L2 between launches.

``bound_ms`` is max(FLOPs / peak, bytes / HBM bandwidth), with the peaks
of the SKU nvidia-smi names (NVIDIA's datasheet): the fp32 CUDA-core peak,
for the flash kernel on bf16 inputs the dense bf16 tensor-core peak, and
for the int8 branches the dense int8 tensor-core peak (1,979 TOP/s on
the H100 SXM), int8 operands counted at one byte.
Both count the real function: for the CNN kernels FLOPs those of the
stored tiles this run's weights hold (2 * pixels * vc * S per strip for a
depthwise conv), bytes the unpadded NHWC input, the stored tiles, bias and
residual read once and the output written once; the stems' zero-padded
input channels (3 -> 8) and the FC heads' padding columns (1000 -> 1024)
are left out of both.  For the flash kernel, FLOPs are 4 * hd per
unmasked (query, key) pair and bytes q, k, v read once and the output
written once.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# fp32 CUDA-core FLOP/s (no tensor cores), HBM bytes/s, dense bf16
# tensor-core FLOP/s and dense int8 tensor-core OP/s per SKU, from NVIDIA's
# datasheets (their sparsity figures halved); matched against the name
# nvidia-smi gives.
PEAKS = (
    ("H100 NVL", 60e12, 3.9e12, 835e12, 1670e12),
    ("H100 PCIe", 51e12, 2.0e12, 756e12, 1513e12),
    ("H100", 67e12, 3.35e12, 989e12, 1979e12),   # H100 SXM5 80GB HBM3
    ("H200", 67e12, 4.8e12, 989e12, 1979e12),
)
RTOL = 1e-5
BF16_RTOL = 1e-2         # the flash kernel on bf16 inputs: p rounded at
                         # 64-key tiles, not 512-key blocks (flash_phase)
BATCH = 8
SIZE = 224
DENSITY = 0.235          # ResNet-18's pruning point
DW_DENSITY = 0.5         # MobileNetV1's


def _peaks(name: str) -> tuple[float, float, float, float]:
    for key, *peaks in PEAKS:
        if key in name:
            return tuple(peaks)
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
    from repro_torch.kernels.capture import no_collection
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
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


def _check(label: str, y, ref, rtol: float = RTOL) -> float:
    rel, abs_err = _rel_err(y, ref)
    if not rel <= rtol:
        raise SystemExit(f"chip_smoke: {label}: kernel vs plain relative "
                         f"error {rel:.3e} > {rtol}")
    return abs_err


class Timer:
    """Times one layer's kernel, plain version and library call, and
    accumulates sums per kernel and per (path, kernel)."""

    def __init__(self, peak_flops: float, peak_bw: float, int8_peak: float):
        self.peak_flops, self.peak_bw = peak_flops, peak_bw
        self.int8_peak = int8_peak
        self.sums: dict = {}
        self.by_path: dict = {}
        self.max_abs_err: dict = {}

    def run(self, label: str, kernel: str, fk, fp, flib, flops: int,
            nbytes: int, reps: int = 20, rtol: float = RTOL,
            peak_flops: float | None = None, **extra) -> dict:
        """``peak_flops`` overrides the fp32 CUDA-core peak (the bf16
        tensor-core peak for bf16 inputs, the int8 one for int8 inputs).
        ``rtol`` 0 asks for bit equality (the int8 kernels)."""
        import torch
        y_k = fk()
        y_p = fp()
        torch.cuda.synchronize()
        err = _check(label, y_k, y_p, rtol)
        rel, _ = _rel_err(y_k, y_p)
        row = {
            "case": label, "kernel": kernel,
            "kernel_ms": _device_ms(fk, reps),
            "kernel_host_loop_ms": _time_ms(fk, reps),
            "plain_ms": _device_ms(fp, max(2, reps // 4)),
            "library_ms": None if flib is None else _device_ms(flib, reps),
            "flops": flops, "bytes": nbytes,
            "flops_bound_ms": flops / (peak_flops or self.peak_flops) * 1e3,
            "bytes_bound_ms": nbytes / self.peak_bw * 1e3,
            "max_abs_err": err, "rel_err": rel, "rtol": rtol, **extra,
        }
        row["bound_ms"] = max(row["flops_bound_ms"], row["bytes_bound_ms"])
        self.max_abs_err[kernel] = max(self.max_abs_err.get(kernel, 0.0), err)
        print(json.dumps(row), flush=True)
        return row

    def add(self, path: str, row: dict) -> None:
        """Add a layer's row to its kernel's sums; a stem-body row also to
        ``"<kernel>:stem"``'s."""
        keys = [row["kernel"]]
        if row.get("body") == "stem":
            keys.append(row["kernel"] + ":stem")
        for table in (self.sums, self.by_path.setdefault(path, {})):
            for key in keys:
                self._add(table, key, row)

    @staticmethod
    def _add(table: dict, key: str, row: dict) -> None:
        s = table.setdefault(key, {
            "ms": 0.0, "host_loop_ms": 0.0, "plain_ms": 0.0,
            "library_ms": 0.0, "flops_bound_ms": 0.0,
            "bytes_bound_ms": 0.0, "layers": 0})
        s["host_loop_ms"] += row["kernel_host_loop_ms"]
        for k in ("flops_bound_ms", "bytes_bound_ms", "plain_ms",
                  "library_ms"):
            s[k] += row[k]
        s["ms"] += row["kernel_ms"]
        s["layers"] += 1
        if "int_mm_ms" in row:  # torch._int_mm, where it took the shape
            s.setdefault("int_mm_ms", 0.0)
            s.setdefault("int_mm_refused_layers", 0)
            if row["int_mm_ms"] is None:
                s["int_mm_refused_layers"] += 1
            else:
                s["int_mm_ms"] += row["int_mm_ms"]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _pruned(gen, kh: int, cin: int, cout: int, vk: int, vn: int,
            density: float):
    """A seeded (kh*kh*cin, cout) f32 weight, balanced-pruned, and its
    tile mask."""
    import numpy as np
    import torch
    from repro_torch.core.pruning import prune_vectors_balanced

    w = (torch.randn(kh * kh * cin, cout, generator=gen)
         * (kh * kh * cin) ** -0.5).numpy()
    if density < 1.0:
        return prune_vectors_balanced(w, density, vk, vn)
    return w, np.ones((w.shape[0] // vk, cout // vn), bool)


def _encode(w, mask, kh: int, cin: int, vk: int, vn: int, device):
    """Encode as the port's sparsify does (cin-major for kh > 1)."""
    import torch
    from repro_torch.core.vector_sparse import conv_cin_major, from_mask

    vs = from_mask(torch.as_tensor(w, device=device), mask, vk, vn)
    return conv_cin_major(vs, cin // vk) if kh > 1 and vk > 1 else vs


def _sparse_weight(gen, kh: int, cin: int, cout: int, vk: int, vn: int,
                   density: float, device):
    """A seeded weight encoded as the port's sparsify does.  ``cin`` is the
    channels per group of a grouped conv; a depthwise tap matrix is
    ``cin=1, vk=1`` (taps stay in ascending order)."""
    w, mask = _pruned(gen, kh, cin, cout, vk, vn, density)
    return _encode(w, mask, kh, cin, vk, vn, device)


def _int8_weight(gen, kh: int, cin: int, cout: int, vk: int, vn: int,
                 density: float, device):
    """As `_sparse_weight`, quantized to int8 as ``sparsify(dtype="int8")``
    does (per-column power-of-two scales of the pruned weight): (the int8
    encoding, the scales on ``device``)."""
    w, mask = _pruned(gen, kh, cin, cout, vk, vn, density)
    return _quantized(w, mask, kh, cin, vk, vn, device)


def _quantized(w, mask, kh: int, cin: int, vk: int, vn: int, device):
    """A pruned weight quantized as ``sparsify(dtype="int8")`` does: (the
    int8 encoding, the per-column power-of-two scales on ``device``)."""
    import torch
    from repro_torch.models.graph import quantize_weights_int8, weight_scales

    s_w = weight_scales(w)
    return (_encode(quantize_weights_int8(w, s_w), mask, kh, cin, vk, vn,
                    device), torch.as_tensor(s_w, device=device))


def _quant_args(timer: Timer, x, quant):
    """The int8 side of a case: with ``quant = (sx, s_w)`` (x and the tiles
    int8) the kernel's kwargs gain the combined scale, the library call
    takes the dequantized input and weight, the bound counts int8
    operations at the int8 peak, the kernel's name gains ``_int8`` and the
    kernel must equal its plain version bit for bit.  Returns (kernel
    kwargs, x for the library, the weight's per-column factor, the peak
    override, the name suffix, the rtol)."""
    if quant is None:
        return {}, x, 1.0, None, "", RTOL
    sx, s_w = quant
    return ({"scale": sx * s_w}, x.float() * sx, s_w, timer.int8_peak,
            "_int8", 0.0)


def _skip_extra(label: str, kernel, reps: int) -> dict:
    """For a case run with the input-side skip off (``kernel(skip)`` calls
    the kernel with ``skip_zero_inputs=skip``): the skip-on output must
    have the skip-off output's bits; both are timed (device ms)."""
    import torch
    y_on, y_off = kernel(True), kernel(False)
    torch.cuda.synchronize()
    if not torch.equal(y_on, y_off):
        raise SystemExit(f"chip_smoke: {label}: skip off differs from skip "
                         f"on (max abs "
                         f"{float((y_on - y_off).abs().max()):.3e})")
    return {"skip_zero_inputs": False, "skip_off_bit_equal_to_on": True,
            "skip_on_ms": _device_ms(lambda: kernel(True), reps)}


def _conv_case(timer: Timer, label: str, x, vs, *, kh: int, stride: int,
               cin_real: int, groups: int = 1, layout: str = "halo",
               bias=None, residual=None, relu: bool = False,
               quant=None, skip: bool = True, reps: int = 20) -> dict:
    """Time a full conv kernel (``layout`` "halo" or "stack") on NHWC ``x``
    against its plain version and cuDNN on the densified (dequantized)
    weight.  ``x`` may carry zero padding channels beyond ``cin_real``;
    the bound counts only the real ones.  ``quant = (sx, s_w)``: x and the
    tiles are int8, the kernel's int8 branch runs, bit-equal to plain.
    ``skip=False``: the kernel runs with the input-side skip off (the row's
    ``kernel_ms``), checked bit-equal to and timed against the skip on
    (`_skip_extra`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.sparse_ops import same_pads
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels import vsconv as K

    n, h, w, c = x.shape
    ho, pt, pb = same_pads(h, kh, stride)
    wo, pl, pr = same_pads(w, kh, stride)
    qkw, x_deq, w_scale, peak, suffix, rtol = _quant_args(timer, x, quant)
    if layout == "halo":
        buf = K.build_halo_input(x, kh=kh, kw=kh, stride=stride, vk=vs.vk)
        kernel, plain, name = (K.vsconv_halo_kernel, K.vsconv_plain,
                               "vsconv_halo")
    else:
        buf = K.build_row_tap_stack(x, kh=kh, kw=kh, stride=stride)
        kernel, plain, name = (K.vsconv_stack_kernel, K.vsconv_stack_plain,
                               "vsconv_stack")
    kw = dict(w_out=wo, kh=kh, kw=kh, stride=stride, groups=groups,
              bias=bias, residual=residual, fuse_relu=relu, **qkw)
    x_lib = F.pad(x_deq, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    w_lib = (decode(vs).float() * w_scale).reshape(kh, kh, c // groups, -1) \
        .permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    out_numel = n * ho * wo * vs.shape[1]
    real = cin_real / c  # the padding channels' share of every stored tile
    stem = K.use_stem_body(c, vs.vk, groups, kh, kh, vs.vn, stride=stride,
                           int8=quant is not None)
    extra = {} if skip else _skip_extra(
        label, lambda on: kernel(buf, vs, skip_zero_inputs=on, **kw), reps)
    if not stem:  # the generic body's plan; a split must be deterministic
        nb, s_steps, vk, vn = vs.vals.shape
        extra["rows"], extra["splits"] = K.conv_plan(
            n * ho * wo, nb, s_steps, vk, vn, int8=quant is not None)
        if extra["splits"] > 1:
            y1, y2 = (kernel(buf, vs, skip_zero_inputs=skip, **kw)
                      for _ in range(2))
            if not torch.equal(y1, y2):
                raise SystemExit(f"chip_smoke: {label}: two launches of a "
                                 f"split conv differ")
            extra["two_launches_bit_equal"] = True
    return timer.run(
        label, name + suffix,
        lambda: kernel(buf, vs, skip_zero_inputs=skip, **kw),
        lambda: plain(buf, vs, **kw),
        lambda: F.conv2d(x_lib, w_lib, bias, stride, groups=groups),
        flops=round(2 * n * ho * wo * vs.vals.numel() * real),
        nbytes=x.element_size() * n * h * w * cin_real
        + round(_nbytes(vs.vals) * real)
        + _nbytes(vs.idx, bias, residual, qkw.get("scale")) + 4 * out_numel,
        reps=reps, rtol=rtol, peak_flops=peak,
        buffer_bytes=_nbytes(buf), body="stem" if stem else "generic",
        **extra)


def _dw_case(timer: Timer, label: str, x, vs, *, stride: int,
             layout: str = "halo", bias=None, residual=None,
             relu: bool = False, quant=None, skip: bool = True,
             reps: int = 20) -> dict:
    """Time a 3x3 depthwise kernel (``layout`` "halo" or "stack") on NHWC
    ``x`` against its plain version and cuDNN's depthwise conv
    (``groups=C``) on the densified (dequantized) tap matrix; ``quant`` and
    ``skip`` as `_conv_case`'s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.sparse_ops import same_pads
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels import vsconv as K
    from repro_torch.kernels import vsconv_dw as D

    n, h, w, c = x.shape
    ho, pt, pb = same_pads(h, 3, stride)
    wo, pl, pr = same_pads(w, 3, stride)
    qkw, x_deq, w_scale, peak, suffix, rtol = _quant_args(timer, x, quant)
    if layout == "halo":
        buf = K.build_halo_input(x, kh=3, kw=3, stride=stride, vk=vs.vn)
        kernel, plain, name = (D.vsconv_dw_halo_kernel, D.vsconv_dw_plain,
                               "vsconv_dw_halo")
    else:
        buf = K.build_row_tap_stack(x, kh=3, kw=3, stride=stride)
        kernel, plain, name = (D.vsconv_dw_stack_kernel,
                               D.vsconv_dw_stack_plain, "vsconv_dw_stack")
    kw = dict(w_out=wo, kh=3, kw=3, stride=stride, bias=bias,
              residual=residual, fuse_relu=relu, **qkw)
    x_lib = F.pad(x_deq, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    w_lib = (decode(vs).float() * w_scale).reshape(3, 3, 1, c) \
        .permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    extra = {} if skip else _skip_extra(
        label, lambda on: kernel(buf, vs, skip_zero_inputs=on, **kw), reps)
    return timer.run(
        label, name + suffix,
        lambda: kernel(buf, vs, skip_zero_inputs=skip, **kw),
        lambda: plain(buf, vs, **kw),
        lambda: F.conv2d(x_lib, w_lib, bias, stride, groups=c),
        flops=2 * n * ho * wo * vs.vals.numel(),
        nbytes=_nbytes(x, vs.vals, vs.idx, bias, residual, qkw.get("scale"))
        + 4 * n * ho * wo * c,
        reps=reps, rtol=rtol, peak_flops=peak,
        buffer_bytes=_nbytes(buf), **extra)


def _int_mm(x, w):
    """torch._int_mm(x, w) (int8 x int8 -> int32, cuBLASLt) as a yardstick:
    (callable, None), or (None, the reason) where it refuses the shape."""
    import torch
    try:
        torch._int_mm(x, w)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).strip().splitlines()[0]
    return (lambda: torch._int_mm(x, w)), None


def _mm_case(timer: Timer, label: str, x, vs, *, n_real: int, bias=None,
             residual=None, relu: bool = False, quant=None,
             skip: bool = True, reps: int = 20) -> dict:
    """Time vsmm on (M, K) ``x`` against its plain version and cuBLAS on the
    densified (dequantized) weight.  Output columns past ``n_real`` are the
    zero padding of a remainder strip; the bound counts only the real
    ones.  ``quant`` and ``skip`` as `_conv_case`'s; int8 rows also time
    ``torch._int_mm`` on the densified int8 weight where it takes the
    shape (``int_mm_ms``; else null and ``int_mm_refused``).  Every row
    names the kernel's plan (``rows``, ``splits``: `vsmm_plan`)."""
    import torch
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels.vsmm import vsmm_kernel, vsmm_plain, vsmm_plan

    qkw, x_deq, w_scale, peak, suffix, rtol = _quant_args(timer, x, quant)
    kw = dict(bias=bias, residual=residual, fuse_relu=relu, **qkw)
    w_lib = decode(vs).float() * w_scale
    lib = ((lambda: torch.addmm(bias, x_deq, w_lib)) if bias is not None
           else (lambda: torch.mm(x_deq, w_lib)))
    extra = {} if skip else _skip_extra(
        label, lambda on: vsmm_kernel(x, vs, skip_zero_inputs=on, **kw),
        reps)
    if quant is not None:
        fn, refused = _int_mm(x, decode(vs))
        extra.update(int_mm_ms=None if fn is None else _device_ms(fn, reps),
                     int_mm_refused=refused)
    m, n_enc = x.shape[0], vs.shape[1]
    nb, s_steps, vk, vn = vs.vals.shape
    extra["rows"], extra["splits"] = vsmm_plan(m, nb, s_steps, vk, vn,
                                               quant is not None)
    real = n_real / n_enc  # balanced pruning: every strip holds S tiles
    return timer.run(
        label, "vsmm" + suffix,
        lambda: vsmm_kernel(x, vs, skip_zero_inputs=skip, **kw),
        lambda: vsmm_plain(x, vs, **kw),
        lib,
        flops=round(2 * m * vs.vals.numel() * real),
        nbytes=_nbytes(x, vs.idx) + round(_nbytes(vs.vals) * real)
        + round(_nbytes(bias, residual, qkw.get("scale")) * real)
        + 4 * m * n_real,
        reps=reps, rtol=rtol, peak_flops=peak, **extra)


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
         32, 1.0, 1, ("halo", "stack")),
        ("stem 7x7/s2 227px cin 3->8 (Hout 114: ragged 8x16 tiles)", 227, 8,
         64, 7, 2, 8, 64, 1.0, 1, ("halo", "stack")),
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
        ("dw2 112->56px C64 s2", 112, 64, 2, ("halo", "stack")),
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
    vsmm_cases(timer, dev, gen, act)
    generic_cases(timer, dev, gen, act, epilogue)
    int8_kernel_cases(timer, dev, gen, act, epilogue)
    skip_cases(timer, dev, gen, act)


def generic_cases(timer: Timer, dev, gen, act, epilogue) -> None:
    """The generic conv body at the main paths' shapes that its plan cuts
    differently, f32 and int8 (bit-equal), both layouts, without and with
    the epilogue: VGG-16's conv2 (224 px, vn 64: 128-row tiles), conv9
    (28 px: 64-row tiles), conv11 (14 px: 2 chunks a strip) and ResNet-18's
    layer4 (7 px: 9 chunks a strip).  Each row names its plan; a split
    case must give the same bits in two launches (`_conv_case`)."""
    from repro_torch.models.graph import quantize_activations_int8

    cases = [  # label, H, cin, cout, vn
        ("VGG-16 conv2 3x3/s1 224px 64->64", 224, 64, 64, 64),
        ("VGG-16 conv9 3x3/s1 28px 512->512", 28, 512, 512, 128),
        ("VGG-16 conv11 3x3/s1 14px 512->512", 14, 512, 512, 128),
        ("ResNet-18 layer4 3x3/s1 7px 512->512", 7, 512, 512, 128),
    ]
    for label, h, cin, cout, vn in cases:
        w, mask = _pruned(gen, 3, cin, cout, 32, vn, DENSITY)
        vs = _encode(w, mask, 3, cin, 32, vn, dev)
        vs8, s_w = _quantized(w, mask, 3, cin, 32, vn, dev)
        x = act(BATCH, h, h, cin)
        xq, sx = quantize_activations_int8(x)
        epi = epilogue(BATCH, h, cout)
        for tag, xin, w_enc, quant in (("", x, vs, None),
                                       ("int8 ", xq, vs8, (sx, s_w))):
            for layout in ("halo", "stack"):
                kw = dict(kh=3, stride=1, cin_real=cin, layout=layout,
                          quant=quant)
                _conv_case(timer, f"{tag}{layout} {label}", xin, w_enc, **kw)
                _conv_case(timer, f"{tag}{layout} {label} "
                           f"+bias+residual+relu", xin, w_enc, **kw, **epi)


def vsmm_cases(timer: Timer, dev, gen, act) -> None:
    """vsmm at the main paths' shapes that the plan splits or tiles
    widest, f32 and int8 (bit-equal), without and with the epilogue:
    VGG-16's fc1 (8 rows, 16 chunks a strip), MobileNetV1's pw1 (128-row
    tiles), pw13 and head.  Each pruned weight serves both branches (int8:
    quantized as ``sparsify(dtype="int8")`` does)."""
    import torch
    from repro_torch.models.graph import quantize_activations_int8

    cases = [  # label, M, K, N (encoded), N (real), vn, density
        ("VGG-16 fc1 25088->4096", BATCH, 25088, 4096, 4096, 128, DENSITY),
        ("MobileNetV1 pw1 112px 32->64", BATCH * 112 * 112, 32, 64, 64, 64,
         DW_DENSITY),
        ("MobileNetV1 pw13 7px 1024->1024", BATCH * 7 * 7, 1024, 1024, 1024,
         128, DW_DENSITY),
        ("MobileNetV1 head 1024->1000 (1024, NB 8)", BATCH, 1024, 1024, 1000,
         128, DW_DENSITY),
    ]
    for label, m, k, n_out, n_real, vn, d in cases:
        w, mask = _pruned(gen, 1, k, n_out, 32, vn, d)
        vs8, s_w = _quantized(w, mask, 1, k, 32, vn, dev)
        vs = _encode(w, mask, 1, k, 32, vn, dev)
        del w
        x = act(m, k)
        xq, sx = quantize_activations_int8(x)
        epi = dict(bias=torch.randn(n_out, generator=gen).to(dev),
                   residual=torch.randn(m, n_out, generator=gen).to(dev),
                   relu=True)
        quant = (sx, s_w)
        for tag, xin, w_enc, q in (("", x, vs, None), ("int8 ", xq, vs8,
                                                       quant)):
            _mm_case(timer, f"{tag}{label}", xin, w_enc, n_real=n_real,
                     quant=q)
            _mm_case(timer, f"{tag}{label} +bias+residual+relu", xin, w_enc,
                     n_real=n_real, quant=q, **epi)


def int8_kernel_cases(timer: Timer, dev, gen, act, epilogue) -> None:
    """The int8 branch of each kernel on the main int8 paths, at the f32
    cases' 224 px geometries, in both layouts, without and with the
    epilogue: int8 tiles and activations quantized on the card as the int8
    path does, each kernel bit-equal to its plain version.  The stems run
    the int8 stem body."""
    import torch
    from repro_torch.models.graph import quantize_activations_int8

    conv_cases = [  # label, H, cin, cout, kh, stride, vk, vn, density
        ("stem 7x7/s2 224px cin 3->8", 224, 8, 64, 7, 2, 8, 64, 1.0),
        ("MobileNetV1 stem 3x3/s2 224px cin 3->8 ->32", 224, 8, 32, 3, 2, 8,
         32, 1.0),
        ("VGG-16 conv1 3x3/s1 224px cin 3->8 ->64", 224, 8, 64, 3, 1, 8, 64,
         1.0),
        ("stem 7x7/s2 227px cin 3->8 (Hout 114: ragged 8x16 tiles)", 227, 8,
         64, 7, 2, 8, 64, 1.0),
        ("3x3/s1 56px 64->64", 56, 64, 64, 3, 1, 32, 64, DENSITY),
        ("3x3/s2 56px 64->128", 56, 64, 128, 3, 2, 32, 128, DENSITY),
        ("3x3/s1 7px 512->512", 7, 512, 512, 3, 1, 32, 128, DENSITY),
        ("3x3/s1 1px 512->512 (32px layer4, Hout<4)", 1, 512, 512, 3, 1,
         32, 128, DENSITY),
    ]
    for label, h, cin, cout, kh, s, vk, vn, d in conv_cases:
        vs, s_w = _int8_weight(gen, kh, cin, cout, vk, vn, d, dev)
        zc = 5 if cin == 8 else 0
        xq, sx = quantize_activations_int8(
            act(BATCH, h, h, cin, zero_channels=zc))
        epi = epilogue(BATCH, -(-h // s), cout)
        kw = dict(kh=kh, stride=s, cin_real=cin - zc, quant=(sx, s_w))
        for layout in ("halo", "stack"):
            _conv_case(timer, f"int8 {layout} {label}", xq, vs, **kw,
                       layout=layout)
            _conv_case(timer, f"int8 {layout} {label} +bias+residual+relu",
                       xq, vs, **kw, layout=layout, **epi)
    for label, h, c, s in [("dw1 112px C32 s1", 112, 32, 1),
                           ("dw2 112->56px C64 s2", 112, 64, 2),
                           ("dw12 14->7px C512 s2", 14, 512, 2)]:
        vs, s_w = _int8_weight(gen, 3, 1, c, 1, min(c, 128), DW_DENSITY, dev)
        xq, sx = quantize_activations_int8(act(BATCH, h, h, c))
        epi = epilogue(BATCH, -(-h // s), c)
        for layout in ("halo", "stack"):
            _dw_case(timer, f"int8 {layout} {label}", xq, vs, stride=s,
                     quant=(sx, s_w), layout=layout)
            _dw_case(timer, f"int8 {layout} {label} +bias+residual+relu", xq,
                     vs, stride=s, quant=(sx, s_w), layout=layout, **epi)
    for label, m, k, n_out, n_real in [
            ("1x1/s2 projection 56px 64->128", BATCH * 28 * 28, 64, 128, 128),
            ("FC 512->1000 (1024, NB 8)", BATCH, 512, 1024, 1000)]:
        vs, s_w = _int8_weight(gen, 1, k, n_out, 32, 128, DENSITY, dev)
        xq, sx = quantize_activations_int8(act(m, k))
        _mm_case(timer, f"int8 {label}", xq, vs, n_real=n_real,
                 quant=(sx, s_w))
        _mm_case(timer, f"int8 {label} +bias+residual+relu", xq, vs,
                 n_real=n_real, quant=(sx, s_w),
                 bias=torch.randn(n_out, generator=gen).to(dev),
                 residual=torch.randn(m, n_out, generator=gen).to(dev),
                 relu=True)


def skip_cases(timer: Timer, dev, gen, act) -> None:
    """``skip_zero_inputs=False`` in every CNN kernel and branch (f32 and
    int8 generic bodies, the f32 stem body, both layouts, the depthwise
    kernels, vsmm), at main-path geometries with the fused epilogue: the
    input is post-ReLU and its first image (vsmm: its first 32 rows; on
    the split path at MobileNetV1's head, 8 rows, half its K-tiles) is all
    zero, so the skip-on kernel skips whole tiles.  The skip-off output
    must have the skip-on bits (`_skip_extra`) and equal the plain version
    (bit for bit in int8); both are timed."""
    import torch
    from repro_torch.models.graph import quantize_activations_int8

    def relu_input(*shape, zero_channels: int = 0):
        x = act(*shape, zero_channels=zero_channels)
        x[0 if len(shape) > 2 else slice(0, 32)] = 0
        return x

    def epi(shape, cout):
        return dict(bias=torch.randn(cout, generator=gen).to(dev),
                    residual=torch.randn(*shape, generator=gen).to(dev),
                    relu=True)

    for int8 in (False, True):
        tag = "int8 " if int8 else ""

        def prep(x, vs_f32, args):
            """(x, weight, quant) for the branch."""
            if not int8:
                return x, vs_f32, None
            vs, s_w = _int8_weight(gen, *args, dev)
            xq, sx = quantize_activations_int8(x)
            return xq, vs, (sx, s_w)

        conv_cases = [  # label, H, cin, cout, kh, stride, vk, vn, density
            ("3x3/s1 56px 64->64", 56, 64, 64, 3, 1, 32, 64, DENSITY),
            ("VGG-16 conv1 3x3/s1 224px cin 3->8 ->64", 224, 8, 64, 3, 1, 8,
             64, 1.0),
        ]
        for label, h, cin, cout, kh, s, vk, vn, d in conv_cases:
            args = (kh, cin, cout, vk, vn, d)
            zc = 5 if cin == 8 else 0
            x, vs, quant = prep(relu_input(BATCH, h, h, cin, zero_channels=zc),
                                _sparse_weight(gen, *args, dev), args)
            ho = -(-h // s)
            for layout in ("halo", "stack"):
                _conv_case(timer, f"skip off {tag}{layout} {label} "
                           f"+bias+residual+relu", x, vs, kh=kh, stride=s,
                           cin_real=cin - zc, layout=layout, quant=quant,
                           skip=False, **epi((BATCH, ho, ho, cout), cout))
        args = (3, 1, 64, 1, 64, DW_DENSITY)
        x, vs, quant = prep(relu_input(BATCH, 112, 112, 64),
                            _sparse_weight(gen, *args, dev), args)
        for layout in ("halo", "stack"):
            _dw_case(timer, f"skip off {tag}{layout} dw2 112->56px C64 s2 "
                     f"+bias+residual+relu", x, vs, stride=2, layout=layout,
                     quant=quant, skip=False, **epi((BATCH, 56, 56, 64), 64))
        m = BATCH * 28 * 28
        args = (1, 64, 128, 32, 128, DENSITY)
        x, vs, quant = prep(relu_input(m, 64),
                            _sparse_weight(gen, *args, dev), args)
        _mm_case(timer, f"skip off {tag}1x1/s2 projection 56px 64->128 "
                 f"+bias+residual+relu", x, vs, n_real=128, quant=quant,
                 skip=False, **epi((m, 128), 128))
        args = (1, 1024, 1024, 32, 128, DW_DENSITY)
        x = act(BATCH, 1024)
        x[:, :512] = 0
        x, vs, quant = prep(x, _sparse_weight(gen, *args, dev), args)
        _mm_case(timer, f"skip off {tag}split MobileNetV1 head 1024->1000 "
                 f"(1024) +bias+residual+relu", x, vs, n_real=1000,
                 quant=quant, skip=False, **epi((BATCH, 1024), 1024))


# label, BH, Tq, Tk, hd, causal, window, q_offset, dtype
FLASH_CASES = [
    ("Qwen admission prefill BH 160 T 512 hd 128 causal bf16", 160, 512,
     512, 128, True, None, 0, "bfloat16"),
    ("Qwen admission prefill BH 160 T 512 hd 128 causal f32", 160, 512, 512,
     128, True, None, 0, "float32"),
    ("Qwen backfill prefill BH 160 T 528 hd 128 causal bf16", 160, 528, 528,
     128, True, None, 0, "bfloat16"),
    ("window 1024 BH 32 T 2048 hd 240 causal bf16", 32, 2048, 2048, 240,
     True, 1024, 0, "bfloat16"),
    ("q_offset 512 BH 160 Tq 64 Tk 576 hd 128 causal bf16", 160, 64, 576,
     128, True, None, 512, "bfloat16"),
    ("hd 64 BH 64 T 1024 causal bf16", 64, 1024, 1024, 64, True, None, 0,
     "bfloat16"),
    ("non-causal BH 128 T 512 hd 80 f32", 128, 512, 512, 80, False, None, 0,
     "float32"),
    ("odd length BH 8 T 33 hd 32 causal f32", 8, 33, 33, 32, True, None, 0,
     "float32"),
]
QWEN_PREFILL_CASE = FLASH_CASES[0][0]


def _attn_mask(tq: int, tk: int, causal: bool, window, q_offset: int, dev):
    """(Tq, Tk) bool, True where query i (at q_offset + i) sees key j."""
    import torch
    qpos = q_offset + torch.arange(tq, device=dev)[:, None]
    kpos = torch.arange(tk, device=dev)[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def flash_phase(timer: Timer, dev, bf16_peak: float) -> dict:
    """The flash kernel against its plain version at the LM paths' shapes:
    relative error within 1e-5 of max|y| in f32 and 1e-2 in bf16 (the
    tensor-core body rounds p to bf16 at the running max of its own 64-key
    tiles, the plain version at that of its blocks of up to 512 keys: a
    bf16 ulp of an element here and there), and two launches bit-equal.
    Each row names the body that ran (`kernel_body`).  The
    library call is `scaled_dot_product_attention` with the same mask
    (``is_causal`` where the mask is plain causal, else an explicit mask)
    in the inputs' dtype.  FLOPs count 4 * hd per unmasked (query, key)
    pair; bytes are q, k, v read once and the output written once.  The
    FLOP bound takes the bf16 dense tensor-core peak for bf16 inputs
    (products of bf16 values are exact in a bf16 MMA with f32
    accumulation) and the fp32 CUDA-core peak for f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import (flash_fwd_kernel,
                                           flash_fwd_plain, kernel_body)

    gen = torch.Generator().manual_seed(2)
    rows = {}
    for (label, bh, tq, tk, hd, causal, window, q_offset,
         dtype) in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(bh, t, hd, generator=gen).to(dev, dt)
                   for t in (tq, tk, tk))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        mask = _attn_mask(tq, tk, causal, window, q_offset, dev)
        pairs = int(mask.sum())
        # (1, BH, T, hd) views: SDPA's fused backends take 4-D inputs
        q4, k4, v4 = q[None], k[None], v[None]
        if causal and window is None and q_offset == 0 and tq == tk:
            lib = lambda q=q4, k=k4, v=v4: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)
        else:
            lib = lambda q=q4, k=k4, v=v4, m=mask: \
                F.scaled_dot_product_attention(q, k, v, attn_mask=m)
        bf16 = dt == torch.bfloat16
        fk = lambda q=q, k=k, v=v, kw=kw: flash_fwd_kernel(q, k, v, **kw)
        if not torch.equal(fk(), fk()):
            raise SystemExit(f"chip_smoke: flash {label}: two launches "
                             f"differ")
        rows[label] = timer.run(
            f"flash {label}", "flash_fwd", fk,
            lambda q=q, k=k, v=v, kw=kw: flash_fwd_plain(q, k, v, **kw),
            lib, flops=4 * bh * pairs * hd,
            nbytes=_nbytes(q, k, v) + q.numel() * q.element_size(),
            reps=10, rtol=BF16_RTOL if bf16 else RTOL,
            peak_flops=bf16_peak if bf16 else None, pairs_per_head=pairs,
            body=kernel_body(dt))
    return rows


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes per entry function from ``nvcc -Xptxas
    -v`` output: {mangled name: {"registers", "spill_stores",
    "spill_loads"}}."""
    usage, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            usage[name] = {"registers": None, "spill_stores": None,
                           "spill_loads": None}
        elif name is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            usage[name]["spill_stores"] = int(m.group(1))
            usage[name]["spill_loads"] = int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            usage[name]["registers"] = int(m.group(1))
    return usage


def flash_instantiations(log: str) -> list:
    """One row per instantiation of ``flash_fwd.cu``'s two bodies: the
    tensor-core body per padded head dim (``hd``, a multiple of 16), the
    CUDA-core body per ``hd`` range of 32 (its slot count x 32)."""
    rows = []
    for name, use in ptxas_usage(log).items():
        if m := re.search(r"flash_mma_kernelILi(\d+)E", name):
            rows.append({"body": "mma", "hd": int(m.group(1)), **use})
        elif m := re.search(r"flash_simt_kernelIfLi(\d+)E", name):
            rows.append({"body": "simt", "hd": 32 * int(m.group(1)), **use})
    return sorted(rows, key=lambda r: (r["body"], r["hd"]))


def stencil_instantiations(conv_log: str, dw_log: str) -> list:
    """One row per instantiation of the stem bodies (``vsconv.cu``, f32 and
    int8: vn = 32 x NC, C input channels) and of the depthwise bodies
    (``vsconv_dw.cu``: VC, 0 for any runtime vc, and VEC floats a copy),
    with their registers and spill bytes."""
    rows = []
    for name, use in ptxas_usage(conv_log).items():
        if m := re.search(r"vsconv_(halo|stack)_stem_(int8_)?kernel"
                          r"ILi(\d+)ELi(\d+)E", name):
            rows.append({"kernel": f"vsconv_{m.group(1)}_stem"
                                   + ("_int8" if m.group(2) else ""),
                         "vn": 32 * int(m.group(3)), "c": int(m.group(4)),
                         **use})
    for name, use in ptxas_usage(dw_log).items():
        if m := re.search(r"vsconv_dw_(halo|stack)_kernelILi(\d+)ELi(\d+)E",
                          name):
            rows.append({"kernel": f"vsconv_dw_{m.group(1)}",
                         "vc": int(m.group(2)), "vec": int(m.group(3)),
                         **use})
    return sorted(rows, key=lambda r: tuple(str(v) for v in r.values()))


def _counters() -> dict:
    """The launch counter of every kernel wrapper, by kernel name."""
    from repro_torch.kernels.capture import wrappers
    return wrappers()


# path -> (config, impl, dtype, requests, launches per wave, stem-body
# launches per wave).  The int8 paths launch the int8 branches only (their
# launches are filed under "<kernel>_int8"); their stems take the int8
# stem body.
PATHS = {
    "resnet18-halo": ("vscnn-resnet18", "auto", None, 16,
                      {"vsconv_halo": 17, "vsmm": 4}, 1),
    "mobilenet_v1-halo": ("vscnn-mobilenet-v1", "auto", None, 16,
                          {"vsconv_halo": 1, "vsconv_dw_halo": 13,
                           "vsmm": 14}, 1),
    "resnet18-int8-halo": ("vscnn-resnet18", "auto", "int8", 16,
                           {"vsconv_halo_int8": 17, "vsmm_int8": 4}, 1),
    "mobilenet_v1-int8-halo": ("vscnn-mobilenet-v1", "auto", "int8", 16,
                               {"vsconv_halo_int8": 1,
                                "vsconv_dw_halo_int8": 13,
                                "vsmm_int8": 14}, 1),
    "mobilenet_v1-stack": ("vscnn-mobilenet-v1", "pallas-stack", None, BATCH,
                           {"vsconv_stack": 1, "vsconv_dw_stack": 13,
                            "vsmm": 14}, 1),
    "resnet18-stack": ("vscnn-resnet18", "pallas-stack", None, BATCH,
                       {"vsconv_stack": 17, "vsmm": 4}, 1),
    "resnet18-int8-stack": ("vscnn-resnet18", "pallas-stack", "int8", BATCH,
                            {"vsconv_stack_int8": 17, "vsmm_int8": 4}, 1),
    "mobilenet_v1-int8-stack": ("vscnn-mobilenet-v1", "pallas-stack", "int8",
                                BATCH, {"vsconv_stack_int8": 1,
                                        "vsconv_dw_stack_int8": 13,
                                        "vsmm_int8": 14}, 1),
    "vgg16-halo": ("vscnn-vgg16", "auto", None, 16,
                   {"vsconv_halo": 13, "vsmm": 3}, 1),
    "vgg16-int8-stack": ("vscnn-vgg16", "pallas-stack", "int8", BATCH,
                         {"vsconv_stack_int8": 13, "vsmm_int8": 3}, 1),
    "resnet34-halo": ("vscnn-resnet34", "auto", None, 16,
                      {"vsconv_halo": 33, "vsmm": 4}, 1),
    "resnet34-int8-halo": ("vscnn-resnet34", "auto", "int8", 16,
                           {"vsconv_halo_int8": 33, "vsmm_int8": 4}, 1),
    "resnet50-halo": ("vscnn-resnet50", "auto", None, 16,
                      {"vsconv_halo": 17, "vsmm": 37}, 1),
    "resnet50-int8-halo": ("vscnn-resnet50", "auto", "int8", 16,
                           {"vsconv_halo_int8": 17, "vsmm_int8": 37}, 1),
}
WARM_SERVES = 5   # warm re-serves of a CNN path's traffic, timed together


def _zero_counters() -> None:
    from repro_torch.kernels.capture import add_counts, counts
    add_counts({k: -n for k, n in counts().items()})


def serve_phase(path: str, dev) -> dict:
    """One path: the port's CNN server answering seeded requests, with
    every kernel's launch count set to 0 just before and read just after.

    The server runs every wave by CUDA-graph replay (`BatchedApply`: one
    graph per shape bucket).  The first wave of a bucket warms the forward
    up eagerly, captures it and replays it: the warm-up's launches ran on
    the device and count, the capture ran nothing and counts nothing
    (`kernels.capture`), and every replay counts the graph's launches.  So
    over a first serve of ``waves`` waves that captured ``graphs`` graphs
    each kernel's count is its launches per wave times (waves + graphs)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CNNServer, ImageRequest
    from repro_torch.models.graph import net_apply

    name, impl, dtype, n_req, per_wave, stem_per_wave = PATHS[path]
    int8 = dtype == "int8"
    cfg = get_config(name)
    t0 = time.perf_counter()
    srv = CNNServer(cfg, batch=BATCH, impl=impl, dtype=dtype, seed=0,
                    device=dev)
    setup_s = time.perf_counter() - t0
    apply = srv.backend.apply
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(n_req)]

    def requests():
        return [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]

    reqs = requests()
    counters = _counters()
    stems = [k for k in counters.values() if hasattr(k, "stem_launches")]
    _zero_counters()
    t0 = time.perf_counter()
    stats = srv.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    suffix = "_int8" if int8 else ""
    launches = {n + suffix: k.launches for n, k in counters.items()
                if k.launches}
    stem_launches = sum(k.stem_launches for k in stems)
    int8_launches = {n: k.int8_launches for n, k in counters.items()
                     if getattr(k, "int8_launches", 0)}

    waves = sum(s["steps"] for s in stats)
    graphs, replays = apply.compiles, apply.replays
    delivered = [r for r in reqs if r.outcome is not None
                 and r.outcome.status == "delivered"]
    if len(delivered) != n_req:
        raise SystemExit(f"chip_smoke: {path}: {len(delivered)}/{n_req} "
                         f"delivered")
    if graphs != 1 or replays != waves:
        raise SystemExit(f"chip_smoke: {path}: {graphs} graphs captured "
                         f"and {replays} replays over {waves} waves, "
                         f"expected 1 and one a wave")
    runs = waves + graphs   # the replays and each graph's warm-up
    expected = {k: v * runs for k, v in per_wave.items()}
    if launches != expected:
        raise SystemExit(f"chip_smoke: {path}: launches {launches} over "
                         f"{waves} waves and {graphs} warm-ups, expected "
                         f"{per_wave} per forward")
    if stem_launches != stem_per_wave * runs:
        raise SystemExit(f"chip_smoke: {path}: the stem body ran "
                         f"{stem_launches} times over {waves} waves and "
                         f"{graphs} warm-ups, expected {stem_per_wave} a "
                         f"forward")
    if int8_launches != ({n: k.launches for n, k in counters.items()
                          if k.launches} if int8 else {}):
        raise SystemExit(f"chip_smoke: {path}: int8 branch launches "
                         f"{int8_launches} of launches {launches}")
    served = np.stack([r.logits for r in reqs])
    if served.shape != (n_req, cfg.num_classes) or \
            not np.isfinite(served).all():
        raise SystemExit(f"chip_smoke: {path}: served logits {served.shape} "
                         f"not finite or of the wrong shape")

    def direct(impl_: str):
        with torch.inference_mode():
            return torch.cat([net_apply(
                srv.net, srv.params,
                torch.from_numpy(np.stack(images[i:i + BATCH])).to(dev),
                sparse=srv.sparse, impl=impl_)
                for i in range(0, n_req, BATCH)]).cpu()

    eager = direct(apply.impl)
    if not np.array_equal(served, eager.numpy()):
        raise SystemExit(f"chip_smoke: {path}: replayed logits differ from "
                         f"eager net_apply(impl={apply.impl!r}) (max abs "
                         f"{_rel_err(torch.from_numpy(served), eager)[1]:.3e})")
    ref = direct("plain")
    rel, abs_err = _rel_err(torch.from_numpy(served), ref)
    if int8 and not np.array_equal(served, ref.numpy()):
        raise SystemExit(f"chip_smoke: {path}: served int8 logits differ "
                         f"from plain net_apply (max abs {abs_err:.3e})")
    if not rel <= RTOL:
        raise SystemExit(f"chip_smoke: {path}: served vs plain net_apply "
                         f"relative error {rel:.3e} > {RTOL}")
    out = {
        "phase": "serve", "path": path, "config": cfg.name, "impl": impl,
        "dtype": dtype or "float32",
        "batch": BATCH, "requests": n_req, "delivered": len(delivered),
        "waves": waves, "graphs": graphs, "replays": replays,
        "launches": launches, "stem_launches": stem_launches,
        "setup_s": setup_s,
        "first_serve_s": serve_s, "first_images_per_s": n_req / serve_s,
        "served_vs_eager_bit_equal": True,
        "served_vs_plain_rel_err": rel,
        "served_vs_plain_bit_equal": bool(np.array_equal(served,
                                                         ref.numpy())),
    }
    # the same traffic again, now warm: steady-state rate, every wave a
    # replay of the captured graph
    t0 = time.perf_counter()
    stats2 = [st for _ in range(WARM_SERVES) for st in srv.serve(requests())]
    torch.cuda.synchronize()
    warm_s = (time.perf_counter() - t0) / WARM_SERVES
    warm_waves = sum(s["steps"] for s in stats2)
    if apply.compiles != graphs or apply.replays != replays + warm_waves:
        raise SystemExit(f"chip_smoke: {path}: the warm serves captured "
                         f"{apply.compiles - graphs} graphs and replayed "
                         f"{apply.replays - replays} of {warm_waves} waves")
    out.update(
        warm_serve_s=warm_s, warm_images_per_s=n_req / warm_s,
        warm_ms_per_wave=1e3 * sum(s["run_s"] for s in stats2) / warm_waves,
        warm_waves=warm_waves, warm_replays=apply.replays - replays)
    print(json.dumps(out), flush=True)
    return {"srv": srv, "images": images, "launches": launches,
            "stem_launches": stem_launches, "warm_s": warm_s,
            "summary": out}


BUCKET_MIX_PATHS = ("resnet18-halo", "resnet18-int8-halo")


def bucket_mix_phase(path: str, served: dict, dev) -> dict:
    """Partial waves on a served path: two shape buckets whose graphs share
    the instance's memory pool, replayed out of their capture order.  The
    server already holds the bucket of 8 (`serve_phase`); 4 requests
    capture the bucket of 4, then 12 requests twice replay 8, 4, 8, 4.
    Counts are set to 0 just before and read just after: each kernel's
    count is its launches per forward times 6 (the new bucket's warm-up
    and 5 replays).  Every wave's logits must equal eager `net_apply` with
    the path's impl on the same batch, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ImageRequest
    from repro_torch.models.graph import net_apply

    _, _, dtype, _, per_wave, _ = PATHS[path]
    srv, images = served["srv"], served["images"][:12]
    apply = srv.backend.apply
    suffix = "_int8" if dtype == "int8" else ""
    with torch.inference_mode():
        eager = {n: net_apply(
            srv.net, srv.params,
            torch.from_numpy(np.stack(images[i:i + n])).to(dev),
            sparse=srv.sparse, impl=apply.impl).cpu().numpy()
            for i, n in ((0, 8), (8, 4))}
    graphs, replays = apply.compiles, apply.replays
    counters = _counters()
    _zero_counters()
    served_logits = []
    for batch in (images[8:], images, images):
        reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(batch)]
        srv.serve(reqs)
        served_logits.append(np.stack([r.logits for r in reqs]))
    launches = {n + suffix: k.launches for n, k in counters.items()
                if k.launches}
    new_graphs, new_replays = apply.compiles - graphs, apply.replays - replays
    if (new_graphs, new_replays) != (1, 5):
        raise SystemExit(f"chip_smoke: {path}: partial waves captured "
                         f"{new_graphs} graphs and replayed {new_replays}, "
                         f"expected 1 and 5")
    if launches != {k: v * 6 for k, v in per_wave.items()}:
        raise SystemExit(f"chip_smoke: {path}: partial waves launched "
                         f"{launches}, expected {per_wave} x 6")
    waves = [(served_logits[0], eager[4])] + [
        (y[a:b], eager[b - a]) for y in served_logits[1:]
        for a, b in ((0, 8), (8, 12))]
    if not all(np.array_equal(y, e) for y, e in waves):
        raise SystemExit(f"chip_smoke: {path}: a partial wave's replayed "
                         f"logits differ from eager net_apply")
    out = {"phase": "bucket_mix", "path": path, "buckets": [8, 4],
           "replay_order": [4, 8, 4, 8, 4], "new_graphs": new_graphs,
           "replays": new_replays, "launches": launches,
           "served_vs_eager_bit_equal": True}
    print(json.dumps(out), flush=True)
    return out


FLEET_PATHS = ("resnet50-halo", "resnet50-int8-halo")
FLEET_PAIRS = 3    # alternating (1 replica, 2 replicas) timing pairs
FLEET_FAULT_REQUESTS = 20   # 2.5 waves: partial waves and steals can occur
FLEET_PROFILE_TRIES = 3


def _recording(backends: list, waves: dict) -> None:
    """Make each CNN backend record, per request it dispatches, the wave
    it ran in: ``waves[rid]`` = (the wave's request ids in slot order, its
    padded batch size).  A re-served request keeps its last wave."""
    for be in backends:
        def dispatch(state, slots, _orig=be.dispatch):
            occ, y = _orig(state, slots)
            wave = (tuple(slots[j].rid for j in occ), int(y.shape[0]))
            for j in occ:
                waves[slots[j].rid] = wave
            return occ, y
        be.dispatch = dispatch


def _fleet_counts(path: str, backends: list, stats: list, counters: dict,
                  launches: dict) -> dict:
    """Per replica: one graph, one replay a wave; the launches, summed
    over the replicas, exactly the path's per forward times (waves +
    graphs), every one of an int8 path an int8 launch."""
    _, _, dtype, _, per_wave, stem_per_wave = PATHS[path]
    int8_launches = {n: k.int8_launches for n, k in counters.items()
                     if getattr(k, "int8_launches", 0)}
    if int8_launches != ({n: k.launches for n, k in counters.items()
                          if k.launches} if dtype == "int8" else {}):
        raise SystemExit(f"chip_smoke: {path} fleet: int8 branch launches "
                         f"{int8_launches} of launches {launches}")
    per_replica = []
    for i, be in enumerate(backends):
        waves = sum(s["steps"] for s in stats if s["replica"] == i)
        apply = be.apply
        if apply.compiles != 1 or apply.replays != waves:
            raise SystemExit(f"chip_smoke: {path} fleet: replica {i} "
                             f"captured {apply.compiles} graphs and replayed "
                             f"{apply.replays} over {waves} waves")
        per_replica.append({"waves": waves, "graphs": apply.compiles,
                            "replays": apply.replays})
    runs = sum(r["waves"] + r["graphs"] for r in per_replica)
    if launches != {k: v * runs for k, v in per_wave.items()}:
        raise SystemExit(f"chip_smoke: {path} fleet: launches {launches} "
                         f"over {per_replica}, expected {per_wave} a "
                         f"forward")
    stems = sum(k.stem_launches for k in counters.values()
                if hasattr(k, "stem_launches"))
    if stems != stem_per_wave * runs:
        raise SystemExit(f"chip_smoke: {path} fleet: the stem body ran "
                         f"{stems} times over {runs} forwards")
    return {"per_replica": per_replica, "forwards": runs}


def fleet_phase(path: str, served: dict, dev) -> dict:
    """The replica fleet on one card (`CNNServer(replicas=2)`: a
    `ReplicaGroup` of two backends, each with its own weights and its own
    `BatchedApply`, behind `FleetScheduler`).

    1. With every count at 0, the path's 16 requests: every logit equal,
       bit for bit, to the one-replica server's (same seed, same images);
       per replica one graph and one replay a wave; the launches summed
       over the replicas exactly the path's per forward x (waves +
       graphs).  The fleet dispatches both replicas' waves before it
       collects either.
    2. Dispatch before collect, by hand: replica 0 and replica 1 each
       dispatch a wave of other images, then both are collected; each
       equal to eager `net_apply` on its batch, bit for bit.
    3. Warm images/s at 1 and 2 replicas, alternating, `FLEET_PAIRS`
       pairs of `WARM_SERVES` serves each (a measurement, no pass mark),
       then one profiled serve of each: the device's idle share.  Each
       trace must hold as many events of each kernel as the path's own
       profile did (the same graphs replay the same waves); a short one
       is taken again, up to `FLEET_PROFILE_TRIES` serves, and the run
       fails if every one is short.
    4. Faults, each on fresh `ChaosBackend`s around the two replicas'
       backends, over `FLEET_FAULT_REQUESTS` requests (the path's 16 and
       4 more): ``FaultPlan.random(0, replicas=2)``, one ``nan`` (replica
       0, its first dispatch), one ``die_collect`` (replica 1, its first
       dispatch) and one ``stall`` (replica 0, 2 ticks: the other replica
       steals half its queue, so waves change size).  Each must give
       exactly one terminal outcome a request, one emission a delivered
       request, a drained replica wherever a fault was not transient (a
       stall is not a fault), and delivered logits held against the
       one-replica server's on the same requests.  f32 logits depend on
       the wave's padded size (it sets the kernels' plans): bit for bit
       where it is the same, within 1e-5 relative where not.  int8 logits
       also depend on the wave's members (the activations' per-tensor
       scale is taken over the wave): bit for bit where the members are
       the same.  A request whose wave changed must equal eager
       `net_apply` on the wave it ran in, bit for bit.  The counts of
       such requests and the max |d| against one replica are printed.
    """
    import numpy as np
    import torch
    from repro_torch.launch.faults import ChaosBackend, Fault, FaultPlan
    from repro_torch.launch.scheduler import DRAINED, FleetScheduler
    from repro_torch.launch.serve import CNNServer, ImageRequest
    from repro_torch.models.graph import net_apply

    name, impl, dtype, n_req, _, _ = PATHS[path]
    int8 = dtype == "int8"
    suffix = "_int8" if int8 else ""
    one = served["srv"]
    images = served["images"]
    cfg = one.cfg
    t0 = time.perf_counter()
    fleet = CNNServer(cfg, batch=BATCH, impl=impl, dtype=dtype, seed=0,
                      replicas=2, device=dev)
    setup_s = time.perf_counter() - t0
    backends = fleet.group.backends
    if len({id(b.apply) for b in backends}) != 2 or \
            backends[0].apply.params["conv1"]["w"].data_ptr() == \
            backends[1].apply.params["conv1"]["w"].data_ptr():
        raise SystemExit(f"chip_smoke: {path} fleet: the replicas share a "
                         f"BatchedApply or weights")

    def requests(ims):
        return [ImageRequest(rid=i, image=im) for i, im in enumerate(ims)]

    # 1. two replicas against one, with exact counts
    ref1 = np.stack([r.logits for r in _serve_one(one, images)])
    counters = _counters()
    _zero_counters()
    reqs = requests(images)
    stats = fleet.serve(reqs)
    torch.cuda.synchronize()
    launches = {n + suffix: k.launches for n, k in counters.items()
                if k.launches}
    if not all(r.outcome is not None and r.outcome.status == "delivered"
               for r in reqs):
        raise SystemExit(f"chip_smoke: {path} fleet: not every request "
                         f"delivered: {fleet.outcomes}")
    got = np.stack([r.logits for r in reqs])
    if not np.array_equal(got, ref1):
        raise SystemExit(f"chip_smoke: {path} fleet: 2 replicas differ from "
                         f"1 (max abs {np.abs(got - ref1).max():.3e})")
    counted = _fleet_counts(path, backends, stats, counters, launches)

    # 2. dispatch before collect, by hand
    rng = np.random.default_rng(7)
    extra = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
             for _ in range(2 * BATCH)]
    waves = [requests(extra[:BATCH]), requests(extra[BATCH:])]
    handles = []
    for be, wave in zip(backends, waves):
        state, _ = be.start(wave, BATCH)
        handles.append((state, be.dispatch(state, wave)))
    for be, wave, (state, h) in zip(backends, waves, handles):
        _, emis = be.collect(state, h, wave)
        with torch.inference_mode():
            eager = net_apply(
                be.apply.net, be.apply.params,
                torch.from_numpy(np.stack([r.image for r in wave])).to(dev),
                sparse=be.apply.sparse, impl=be.apply.impl).cpu().numpy()
        if not np.array_equal(np.stack(emis), eager):
            raise SystemExit(f"chip_smoke: {path} fleet: a wave dispatched "
                             f"before the other replica's was collected "
                             f"differs from eager net_apply")

    # 3. warm images/s at 1 and 2 replicas, alternating
    servers = {1: one, 2: fleet}
    rates: dict = {1: [], 2: []}
    for pair in range(FLEET_PAIRS):
        for n in ((1, 2) if pair % 2 == 0 else (2, 1)):
            t0 = time.perf_counter()
            for _ in range(WARM_SERVES):
                servers[n].serve(requests(images))
            torch.cuda.synchronize()
            rates[n].append(WARM_SERVES * n_req
                            / (time.perf_counter() - t0))
    idle = {}
    expect = served["profile"]["kernel_events_by_kind"]
    for n, srv in servers.items():
        prof = profile_phase(f"{path} x{n} replicas",
                             lambda srv=srv: srv.serve(requests(images)),
                             n_req / float(np.median(rates[n])), int8=int8,
                             expect=expect,
                             tries=FLEET_PROFILE_TRIES)
        idle[n] = {k: prof[k] for k in ("device_idle_share",
                                        "idle_share_est_two_serves",
                                        "device_busy_ms", "wall_ms",
                                        "attempts", "device_margin_us")}

    # 4. faults
    fault_images = images + [rng.standard_normal((SIZE, SIZE, 3)).astype(
        np.float32) for _ in range(FLEET_FAULT_REQUESTS - n_req)]
    ref_waves: dict = {}
    _recording([one.backend], ref_waves)
    ref_reqs = _serve_one(one, fault_images)
    del one.backend.dispatch
    ref = {r.rid: r.logits for r in ref_reqs}
    apply = backends[0].apply

    def eager(wave):
        """Eager `net_apply` on the padded batch a wave ran."""
        rids, nb = wave
        x = np.zeros((nb, SIZE, SIZE, 3), np.float32)
        for i, rid in enumerate(rids):
            x[i] = fault_images[rid]
        with torch.inference_mode():
            return net_apply(apply.net, apply.params,
                             torch.from_numpy(x).to(dev), sparse=apply.sparse,
                             impl=apply.impl).cpu().numpy()

    plans = {
        "random_seed_0": FaultPlan.random(0, replicas=2),
        "nan_r0w1": FaultPlan([Fault("nan", 0, 1)]),
        "die_collect_r1w1": FaultPlan([Fault("die_collect", 1, 1)]),
        "stall_r0w1": FaultPlan([Fault("stall", 0, 1, ticks=2)]),
    }
    faults = {}
    for label, plan in plans.items():
        got_waves: dict = {}
        _recording(backends, got_waves)
        try:
            chaos = [ChaosBackend(b, plan, replica=i)
                     for i, b in enumerate(backends)]
            sched = FleetScheduler(chaos, batch=BATCH)
            reqs = requests(fault_images)
            sched.serve(reqs)
            torch.cuda.synchronize()
        finally:
            for b in backends:
                del b.dispatch
        if set(sched.outcomes) != {r.rid for r in reqs} or \
                any(r.outcome is not sched.outcomes[r.rid] for r in reqs):
            raise SystemExit(f"chip_smoke: {path} {label}: not one terminal "
                             f"outcome a request")
        delivered = [r for r in reqs if r.outcome.status == "delivered"]
        if any(len(r.out) != 1 or r.logits is None for r in delivered):
            raise SystemExit(f"chip_smoke: {path} {label}: a delivered "
                             f"request has {[len(r.out) for r in reqs]} "
                             f"emissions")
        if any(sched.health[e["replica"]] != DRAINED
               for e in sched.fault_events if not e["transient"]):
            raise SystemExit(f"chip_smoke: {path} {label}: health "
                             f"{sched.health} after {sched.fault_events}")
        # f32 depends on the padded size (the kernels' plans), int8 also on
        # the wave's members (the per-tensor activation scale)
        size_changed = [r.rid for r in delivered
                        if got_waves[r.rid][1] != ref_waves[r.rid][1]]
        wave_changed = [r.rid for r in delivered
                        if set(got_waves[r.rid][0])
                        != set(ref_waves[r.rid][0])
                        or got_waves[r.rid][1] != ref_waves[r.rid][1]]
        same = (lambda rid: rid not in wave_changed) if int8 else \
            (lambda rid: rid not in size_changed)
        eagers: dict = {}
        max_d, max_rel = 0.0, 0.0
        for r in delivered:
            d = float(np.abs(r.logits.astype(np.float64)
                             - ref[r.rid]).max())
            rel = d / max(float(np.abs(ref[r.rid]).max()), 1e-30)
            if same(r.rid) and d != 0.0:
                raise SystemExit(f"chip_smoke: {path} {label}: request "
                                 f"{r.rid} (wave {got_waves[r.rid]}, alone "
                                 f"{ref_waves[r.rid]}) differs from the "
                                 f"one-replica server by {d:.3e}")
            if not int8 and rel > RTOL:
                raise SystemExit(f"chip_smoke: {path} {label}: request "
                                 f"{r.rid} relative error {rel:.3e} > {RTOL}")
            if not same(r.rid):
                wave = got_waves[r.rid]
                if wave not in eagers:
                    eagers[wave] = eager(wave)
                if not np.array_equal(r.logits,
                                      eagers[wave][wave[0].index(r.rid)]):
                    raise SystemExit(f"chip_smoke: {path} {label}: request "
                                     f"{r.rid} differs from eager net_apply "
                                     f"on the wave {wave} it ran in")
            max_d, max_rel = max(max_d, d), max(max_rel, rel)
        faults[label] = {
            "plan": plan.describe(), "requests": len(reqs),
            "delivered": len(delivered),
            "refused": sorted({r.outcome.reason for r in reqs
                               if r.outcome.status == "refused"}),
            "health": list(sched.health),
            "fault_events": [(e["wave"], e["replica"], e["fault"])
                             for e in sched.fault_events],
            "injected": [b.injected for b in chaos], "steals": sched.steals,
            "padded_size_changed": len(size_changed),
            "wave_members_changed": len(wave_changed),
            "checked_against_eager_on_own_wave": len(
                [r for r in delivered if not same(r.rid)]),
            "max_abs_diff_vs_one_replica": max_d,
            "max_rel_diff_vs_one_replica": max_rel}
    out = {"phase": "fleet", "path": path, "replicas": 2,
           "setup_s": setup_s, "requests": n_req, "launches": launches,
           **counted, "two_vs_one_bit_equal": True,
           "dispatch_before_collect_bit_equal": True,
           "warm_images_per_s": {str(n): v for n, v in rates.items()},
           "warm_images_per_s_median": {str(n): float(np.median(v))
                                        for n, v in rates.items()},
           "idle": {str(n): v for n, v in idle.items()}, "faults": faults}
    print(json.dumps(out), flush=True)
    return out


def _serve_one(srv, images) -> list:
    from repro_torch.launch.serve import ImageRequest
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]
    srv.serve(reqs)
    if not all(r.outcome.status == "delivered" for r in reqs):
        raise SystemExit("chip_smoke: the one-replica server refused a "
                         "request")
    return reqs


CLI_RUNS = {
    "cnn": ["--cnn", "vscnn-resnet50", "--replicas", "2", "--chaos-seed",
            "0"],
    "lm": ["--arch", "qwen1.5-4b", "--requests", "4", "--tokens", "8"],
}


def cli_phase() -> dict:
    """The serve CLI as a user starts it, on the card, in processes of its
    own (``python -m repro_torch.launch.serve``, the reduced configs),
    both started together: ResNet-50 on two replicas under the seeded
    chaos plan, and Qwen1.5-4B with 4 requests of 8 tokens.  Each must
    exit 0 and print its summary line: every request accounted for
    (delivered + refused = 16), and 4 x 8 tokens."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    out = {"phase": "cli"}
    t0 = time.perf_counter()
    procs = {label: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for label, argv in CLI_RUNS.items()}
    done = {}
    try:
        for label, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            done[label] = (proc.returncode, stdout, stderr,
                           time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for label, argv in CLI_RUNS.items():
        rc, text, stderr, secs = done[label]
        if rc != 0:
            raise SystemExit(f"chip_smoke: cli {label} exited {rc}:\n"
                             f"{text}\n{stderr[-4000:]}")
        if label == "cnn":
            m = re.search(r"served (\d+) images in (\d+) lockstep runs, "
                          r"([\d.]+) img/s", text)
            o = re.search(r"outcomes: (\d+) delivered, (\d+) refused", text)
            if m is None or o is None or \
                    int(o.group(1)) + int(o.group(2)) != 16 or \
                    int(m.group(1)) != int(o.group(1)):
                raise SystemExit(f"chip_smoke: cli {label}: summary not "
                                 f"parsed or requests lost:\n{text}")
            row = {"images": int(m.group(1)), "runs": int(m.group(2)),
                   "images_per_s": float(m.group(3)),
                   "delivered": int(o.group(1)), "refused": int(o.group(2))}
        else:
            m = re.search(r"served (\d+) requests in (\d+) lockstep runs: "
                          r"(\d+) tokens, ([\d.]+) tok/s", text)
            if m is None or int(m.group(1)) != 4 or int(m.group(3)) != 32:
                raise SystemExit(f"chip_smoke: cli {label}: summary not "
                                 f"parsed or tokens lost:\n{text}")
            row = {"requests": int(m.group(1)), "runs": int(m.group(2)),
                   "tokens": int(m.group(3)),
                   "decode_tok_s": float(m.group(4))}
        out[label] = {"argv": argv, "seconds": secs, **row,
                      "summary": text.splitlines()[0]}
    print(json.dumps(out), flush=True)
    return out


def _kind(name: str) -> str:
    # a stem body is filed under its kernel, vsmm's phase 2 under vsmm
    m = re.search(r"(vsconv_dw_halo|vsconv_dw_stack|vsconv_halo|"
                  r"vsconv_stack|vsmm|flash_fwd)_(?:stem_)?(int8_)?"
                  r"(?:reduce_)?kernel", name)
    if m:
        return m.group(1) + ("_int8" if m.group(2) else "")
    if "flash_mma_kernel" in name or "flash_simt_kernel" in name:
        return "flash_fwd"   # the flash kernel's bf16 and f32 bodies
    if "Memcpy" in name or "Memset" in name:
        return "copy"
    if any(key in name for key in ("gemm", "nvjet", "xmma", "cutlass",
                                   "splitK")):
        return "gemm"
    return "other"


def _device_spans(events) -> list:
    """(start us, end us, name) of every device event of a profile."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA)


def _device_time(spans: list) -> tuple[float, dict]:
    """(busy us, the union of the spans' intervals; {name: (device ms,
    events)})."""
    busy_us, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, n + 1)
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us, by_name


PROFILE_SLACK_S = 0.05   # idle host time at each end of a profile window
SERVE_RANGE = "chip_smoke_serve"   # the profiled serve's `record_function`


def profile_phase(path: str, serve, warm_s: float, int8: bool = False,
                  expect: dict | None = None, tries: int = 1) -> dict:
    """One more warm serve of the path's traffic (``serve()``) under
    `torch.profiler`: the device's busy time (the union of its kernel and
    copy intervals) against the wall clock of the same serve, and device
    time by kind.  The profiler's own host overhead lengthens the wall
    clock, so that idle share is an upper bound.  The busy time over
    ``warm_s``, the wall clock of an earlier unprofiled serve of the same
    traffic, is printed as an estimate built from two serves.  A trace
    without device events fails the run: the launch counts of a replayed
    graph are the capture's record, and the trace is what shows that the
    device ran them.

    The serve replays CUDA graphs: CUPTI reports each kernel node of a
    replay as a device event of its own, and the busy time is the union of
    those (device events only; ``cudaGraphLaunch`` is a host event,
    counted apart as ``graph_launches``).  The trace must hold at least
    one device event of each kernel for each launch that the wrappers'
    counters gave the serve (a split vsmm or conv launch runs two kernels
    of its kind), ``int8`` naming the int8 branches, and at least the
    events of each kernel in ``expect`` (another profile of the same
    graphs on the same waves).  The profiler keeps only device events
    whose times fall inside its window, so the serve runs between two
    idle `PROFILE_SLACK_S` stretches, and ``device_margin_us`` says how
    far the first and last device events lay inside the serve's own host
    span (negative: outside it, a clock offset).  A short trace is taken
    again, up to ``tries`` serves in all (each shortfall is printed,
    ``profile_short``); the run fails if every one is short."""
    for attempt in range(1, tries + 1):
        out = _profile_once(path, serve, warm_s, int8, expect or {})
        if not out["unseen"]:
            break
        print(json.dumps({"phase": "profile_short", "path": path,
                          "attempt": attempt, "unseen": out["unseen"],
                          "graph_launches": out["graph_launches"],
                          "device_margin_us": out["device_margin_us"]}),
              flush=True)
    else:
        raise SystemExit(f"chip_smoke: {path}: {tries} profiles saw fewer "
                         f"kernel events than needed (events, needed): "
                         f"{out['unseen']}")
    out["attempts"] = attempt
    print(json.dumps(out), flush=True)
    return out


def _profile_once(path: str, serve, warm_s: float, int8: bool,
                  expect: dict) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    counters = _counters()
    before = {n: k.launches for n, k in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_SLACK_S)
        t0 = time.perf_counter()
        with record_function(SERVE_RANGE):
            serve()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_SLACK_S)
    suffix = "_int8" if int8 else ""
    launched = {n + suffix: k.launches - before[n]
                for n, k in counters.items() if k.launches != before[n]}
    events = prof.events()
    # the range's device-side annotation spans all of its work: not work
    spans = _device_spans(events)
    annotations = sum(sp[2] == SERVE_RANGE for sp in spans)
    spans = [sp for sp in spans if sp[2] != SERVE_RANGE]
    graph_launches = sum(e.name == "cudaGraphLaunch" for e in events
                         if e.device_type == DeviceType.CPU)
    busy_us, by_name = _device_time(spans)
    by_kind: dict = {}
    events_by_kind: dict = {}
    for name, (ms, n) in by_name.items():
        kind = _kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        events_by_kind[kind] = events_by_kind.get(kind, 0) + n
    need = {k: max(n, expect.get(k, 0)) for k, n in launched.items()}
    unseen = {k: (events_by_kind.get(k, 0), n) for k, n in need.items()
              if events_by_kind.get(k, 0) < n}
    if not spans:
        raise SystemExit(f"chip_smoke: {path}: the profile holds no device "
                         f"event, so it cannot show that the counted "
                         f"launches {launched} ran")
    host = next(e.time_range for e in events
                if e.name == SERVE_RANGE
                and e.device_type == DeviceType.CPU)
    margin = [spans[0][0] - host.start,
              host.end - max(end for _, end, _ in spans)]
    return {"phase": "profile", "path": path, "wall_ms": wall_ms,
           "device_events": len(spans), "graph_launches": graph_launches,
           "launches": launched, "kernel_events_by_kind": events_by_kind,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
           "idle_share_est_two_serves": 1 - busy_us / 1e3 / (warm_s * 1e3),
           "device_ms_by_kind": by_kind, "unseen": unseen,
           "device_margin_us": margin, "annotations_dropped": annotations}


LM_CONFIG = "qwen1.5-4b"
LM_BATCH = 8
LM_CAPACITY = 512 + 32 + 8   # the reference main's round_up(512, 16) + 32 + 8
LOGITS_RTOL = 2e-2           # bf16 prefill: kernel path vs plain path...
# ...unless other valid attention implementations (f32 attention with p
# unrounded, SDPA) already put the plain path's logits further apart: the
# bound is then that noise floor (see lm_check_phase)
F32_LOGITS_RTOL = 1e-4       # the same prefill with the weights in f32


def _lm_traffic(vocab: int) -> list:
    """Seeded traffic: 12 prompts of 497-512 tokens (one length bucket)
    with max_new drawn from 8-32, then 4 prompts of 241-256 tokens with
    max_new 16.  The first run admits 8 long prompts, retires the short
    budgets early and backfills from the other 4."""
    import numpy as np
    rng = np.random.default_rng(0)
    long = [(i, rng.integers(0, vocab, int(rng.integers(497, 513)),
                             dtype=np.int32), int(rng.integers(8, 33)))
            for i in range(12)]
    short = [(i, rng.integers(0, vocab, int(rng.integers(241, 257)),
                              dtype=np.int32), 16)
             for i in range(12, 16)]
    return long + short


def _lm_requests(traffic: list) -> list:
    from repro_torch.launch.serve import Request
    return [Request(rid=r, prompt=p, max_new=m) for r, p, m in traffic]


def _lm_stats(stats: list) -> dict:
    """A serve's stats, per lockstep run and summed."""
    return {
        "runs": len(stats),
        "prefill_s_per_run": [s["prefill_s"] for s in stats],
        "decode_s_per_run": [s["decode_s"] for s in stats],
        "decode_steps": sum(s["decode_steps"] for s in stats),
        "backfills": sum(s["backfills"] for s in stats),
        "tokens": sum(s["new_tokens"] for s in stats),
        "decode_tok_s": sum(s["new_tokens"] for s in stats)
        / sum(s["decode_s"] for s in stats),
        "ms_per_step_in_runs": 1e3 * sum(s["decode_s"] for s in stats)
        / max(sum(s["decode_steps"] for s in stats), 1),
    }


def lm_serve_phase(dev) -> dict:
    """The port's LM `Server` serving Qwen1.5-4B (full depth and width,
    bf16 weights from seed 0) at batch 8: every launch count set to 0 just
    before the serve and read just after.  Every request must be delivered
    with ``max_new`` tokens in [0, padded_vocab), and the flash kernel
    launched exactly once per layer per prefill: 40 x (lockstep runs +
    backfills), so none in decode steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Server

    cfg = get_config(LM_CONFIG)
    t0 = time.perf_counter()
    srv = Server(cfg, batch=LM_BATCH, capacity=LM_CAPACITY, seed=0,
                 device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    traffic = _lm_traffic(cfg.vocab)
    reqs = _lm_requests(traffic)
    counters = _counters()
    _zero_counters()
    t0 = time.perf_counter()
    stats = srv.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in counters.items() if k.launches}

    summary = _lm_stats(stats)
    delivered = [r for r in reqs if r.outcome is not None
                 and r.outcome.status == "delivered"]
    if len(delivered) != len(reqs):
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: {len(delivered)}/"
                         f"{len(reqs)} delivered")
    for r in reqs:
        if len(r.out) != r.max_new or not all(
                isinstance(t, int) and 0 <= t < cfg.padded_vocab
                for t in r.out):
            raise SystemExit(f"chip_smoke: {LM_CONFIG}: request {r.rid} "
                             f"emitted {r.out} for max_new {r.max_new}")
    prefills = summary["runs"] + summary["backfills"]
    expected = {"flash_fwd": cfg.total_layers * prefills}
    if launches != expected:
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: launches {launches}, "
                         f"expected {expected} ({summary['runs']} runs + "
                         f"{summary['backfills']} backfills)")
    graphs = srv.backend.graphs
    replays = sum(g.graph.replays for g in graphs.values())
    if list(graphs) != [(LM_BATCH, LM_CAPACITY)] or \
            replays != summary["decode_steps"]:
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: decode graphs "
                         f"{list(graphs)} replayed {replays} times over "
                         f"{summary['decode_steps']} decode steps, expected "
                         f"one graph at (batch, capacity) replayed each step")
    out = {"phase": "serve", "path": LM_CONFIG, "config": cfg.name,
           "layers": cfg.total_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "dtype": cfg.param_dtype, "batch": LM_BATCH,
           "capacity": LM_CAPACITY, "requests": len(reqs),
           "delivered": len(delivered), "launches": launches,
           "decode_graphs": len(graphs), "decode_replays": replays,
           "setup_s": setup_s, "first_serve_s": serve_s, **summary}
    print(json.dumps(out), flush=True)
    return {"srv": srv, "traffic": traffic, "reqs": reqs,
            "launches": launches, "summary": out}


def _logits_spread(srv, batch: dict, logits, logits_plain) -> dict:
    """How far apart other valid attention implementations put the same
    bf16 prefill's logits (relative to max|logit|): the kernel run again
    (determinism); attention in f32 with p unrounded and the output
    rounded to bf16 (the reference's jnp flash); SDPA; and the whole
    prefill with the weights in f32, kernel vs plain."""
    import dataclasses
    from unittest import mock

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash import flash_fwd_plain
    from repro_torch.models import attention, transformer as tfm

    cfg, cap = srv.cfg, srv.capacity

    def run(fn=None, params=None, c=cfg):
        params = srv.params if params is None else params
        if fn is None:
            return tfm.prefill(params, batch, c, capacity=cap)[0]
        with mock.patch.object(attention, "flash_fwd_kernel", fn):
            return tfm.prefill(params, batch, c, capacity=cap)[0]

    def f32_attention(q, k, v, **kw):
        return flash_fwd_plain(q.float(), k.float(), v.float(),
                               **kw).to(q.dtype)

    def sdpa(q, k, v, *, causal, window, q_offset):
        assert window is None and q_offset == 0
        return F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal)[0]

    out = {
        "kernel_vs_kernel_again": _rel_err(logits, run())[0],
        "plain_vs_f32_attention": _rel_err(logits_plain,
                                           run(f32_attention))[0],
        "plain_vs_sdpa": _rel_err(logits_plain, run(sdpa))[0],
    }
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                cache_dtype_str="float32")
    p32 = _tree_map(lambda t: t.float(), srv.params)
    out["f32_weights_kernel_vs_plain"] = _rel_err(
        run(params=p32, c=cfg32), run(flash_fwd_plain, p32, cfg32))[0]
    del p32
    torch.cuda.empty_cache()
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def lm_check_phase(srv, reqs: list, dev) -> dict:
    """The first run's admitted batch (the first bucket, longest prompts
    first, as the scheduler admits it), re-run directly on the card.

    Its admission prefill through the kernel against the same prefill
    through `flash_fwd_plain`, relative to max|logit|: with the weights in
    f32 within 1e-4; as served (bf16) within 2e-2 or, where two other
    valid attention implementations already differ from the plain path by
    more (`_logits_spread`: on this random-weight 40-layer model any
    bf16 rounding difference grows to about 2e-2), within that noise
    floor.  A greedy `prefill` + `decode_step` loop over the batch must
    emit exactly the tokens the server delivered (lanes are independent:
    same shapes, same kernels).  The loop's decode steps must launch no
    flash kernel; their time per step is taken here (batch 8, one token a
    lane, CUDA-synchronized wall clock)."""
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.kernels.flash import flash_fwd_kernel, flash_fwd_plain
    from repro_torch.models import attention, transformer as tfm

    be, cfg = srv.backend, srv.cfg
    key = be.bucket_key(reqs[0])
    first = sorted([r for r in reqs if be.bucket_key(r) == key],
                   key=be.sort_key)[:LM_BATCH]
    toks = np.zeros((LM_BATCH, key), np.int64)
    for i, r in enumerate(first):
        toks[i, key - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    logits, caches = tfm.prefill(srv.params, batch, cfg,
                                 capacity=srv.capacity)
    with mock.patch.object(attention, "flash_fwd_kernel", flash_fwd_plain):
        n0 = flash_fwd_kernel.launches
        logits_plain, _ = tfm.prefill(srv.params, batch, cfg,
                                      capacity=srv.capacity)
        if flash_fwd_kernel.launches != n0:
            raise SystemExit("chip_smoke: the plain prefill launched the "
                             "flash kernel")
    rel, _ = _rel_err(logits, logits_plain)
    spread = _logits_spread(srv, batch, logits, logits_plain)
    floor = max(spread["plain_vs_f32_attention"], spread["plain_vs_sdpa"])
    f32_rel = spread["f32_weights_kernel_vs_plain"]
    print(json.dumps({"phase": "lm_logits_spread", "path": LM_CONFIG,
                      "kernel_vs_plain": rel, **spread,
                      "bf16_noise_floor": floor,
                      "within_2e-2": rel <= 2e-2}), flush=True)
    if not f32_rel <= F32_LOGITS_RTOL:
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: f32-weight prefill "
                         f"logits, kernel vs plain, relative error "
                         f"{f32_rel:.3e} > {F32_LOGITS_RTOL}")
    if not rel <= max(LOGITS_RTOL, floor):
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: prefill logits, kernel "
                         f"vs plain, relative error {rel:.3e} > "
                         f"{LOGITS_RTOL} and > the bf16 noise floor "
                         f"{floor:.3e}")
    steps = max(r.max_new for r in first) - 1
    nxt = torch.argmax(logits, dim=-1)
    emitted = [nxt]
    n0 = flash_fwd_kernel.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, caches = tfm.decode_step(srv.params, caches, nxt[:, None],
                                         key + i, cfg)
        nxt = torch.argmax(logits, dim=-1)
        emitted.append(nxt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if flash_fwd_kernel.launches != n0:
        raise SystemExit("chip_smoke: a decode step launched the flash "
                         "kernel")
    direct = torch.stack(emitted, dim=1).cpu().numpy()
    bad = [r.rid for j, r in enumerate(first)
           if r.out != direct[j, :r.max_new].tolist()]
    if bad:
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: requests {bad} of the "
                         f"first run differ from the direct greedy loop")
    out = {"phase": "lm_check", "path": LM_CONFIG,
           "first_run_rids": [r.rid for r in first],
           "prefill_logits_kernel_vs_plain_rel_err": rel,
           "logits_spread": spread,
           "greedy_loop_steps": steps, "greedy_loop_match": True,
           "decode_step_ms": 1e3 * decode_s / steps,
           "decode_tok_s_full_batch": LM_BATCH * steps / decode_s}
    print(json.dumps(out), flush=True)
    return out


def lm_warm_phase(srv, traffic: list) -> dict:
    """The same traffic again, warm: prefill seconds per run, decode
    tokens/s and ms per decode step (backfill prefills inside the runs
    included)."""
    import torch
    t0 = time.perf_counter()
    stats = srv.serve(_lm_requests(traffic))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    out = {"phase": "warm_serve", "path": LM_CONFIG, "warm_serve_s": warm_s,
           **_lm_stats(stats)}
    print(json.dumps(out), flush=True)
    return out


def lm_decode_phase(srv, traffic: list, dev) -> dict:
    """The decode step at batch 8, warm, through the server's graph.

    The first 8 long prompts are admitted (`LMBackend.start`, a prefill
    into the backend's caches).  Then one replayed step's logits and
    caches must equal, bit for bit, an eager `decode_step` from copies of
    the same caches at the same tokens and position.  Then: ms per
    `LMBackend.step` (the replay, sampling and the tokens' copy to the
    host; CUDA-synchronized wall clock over 16 steps), device ms per
    replay (CUDA events over 10 replays of the graph at one position),
    and, under `torch.profiler`, the device operations and busy ms of one
    replay (5 replays) and its 15 costliest kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tfm

    be, cfg = srv.backend, srv.cfg
    first = _lm_requests(traffic)[:LM_BATCH]
    state, _ = be.start(first, LM_BATCH)
    g = be.graphs[(LM_BATCH, srv.capacity)]
    pos = state["len"] + state["i"]
    copies = _tree_map(lambda t: t.clone(), state["caches"])
    g.tokens.copy_(state["nxt"])
    g.pos.fill_(pos)
    g.graph.replay()
    eager, copies = tfm.decode_step(srv.params, copies, state["nxt"], pos,
                                    cfg)
    torch.cuda.synchronize()
    if not torch.equal(g.logits, eager):
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: a replayed decode "
                         f"step's logits differ from eager decode_step (max "
                         f"abs {_rel_err(g.logits, eager)[1]:.3e})")
    leaves = []
    _tree_map(leaves.append, [state["caches"], copies])
    half = len(leaves) // 2
    if not all(torch.equal(a, b) for a, b in zip(leaves[:half],
                                                  leaves[half:])):
        raise SystemExit(f"chip_smoke: {LM_CONFIG}: a replayed decode "
                         f"step's caches differ from eager decode_step's")
    del copies, leaves
    torch.cuda.empty_cache()
    steps = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = be.step(state, first)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        g.graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            g.graph.replay()
        torch.cuda.synchronize()
    spans = _device_spans(prof.events())
    busy_us, by_name = _device_time(spans)
    by_kind: dict = {}
    for name, (ms, _) in by_name.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + ms / 5
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out = {"phase": "lm_decode", "path": LM_CONFIG, "batch": LM_BATCH,
           "capacity": LM_CAPACITY, "position": pos,
           "replay_vs_eager_bit_equal": True,
           "step_ms": step_ms, "replay_device_ms": replay_ms,
           "device_ops_per_step": len(spans) / 5 if spans else None,
           "device_busy_ms_per_step": busy_us / 5e3 if spans else None,
           "device_ms_per_step_by_kind": by_kind,
           "top_kernels_per_step": [{"name": name[:120], "ms": ms / 5,
                                     "calls": n / 5}
                                    for name, (ms, n) in top],
           "decode_replays": g.graph.replays}
    print(json.dumps(out), flush=True)
    return out


def prefill_breakdown_phase(srv, flash_row: dict, dev) -> dict:
    """One batch-8, T-512 prefill of the served model: its time (CUDA
    events around a host loop of 3 prefills), the flash kernel's device
    time per layer and per prefill (x layers, from the kernel phase's
    Qwen bf16 case, the same shape), its plain, library and bound times
    likewise, and the rest of the prefill."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tfm

    cfg = srv.cfg
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (LM_BATCH, 512))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    prefill_ms = _time_ms(lambda: tfm.prefill(srv.params, batch, cfg,
                                              capacity=srv.capacity), 3)
    n = cfg.total_layers
    out = {"phase": "prefill_breakdown", "path": LM_CONFIG,
           "batch": LM_BATCH, "T": 512, "layers": n,
           "prefill_ms": prefill_ms,
           "flash_ms_per_layer": flash_row["kernel_ms"],
           "flash_ms_per_prefill": n * flash_row["kernel_ms"],
           "flash_host_loop_ms_per_prefill":
               n * flash_row["kernel_host_loop_ms"],
           "plain_ms_per_prefill": n * flash_row["plain_ms"],
           "library_ms_per_prefill": n * flash_row["library_ms"],
           "bound_ms_per_prefill": n * flash_row["bound_ms"],
           "rest_of_prefill_ms": prefill_ms - n * flash_row["kernel_ms"]}
    print(json.dumps(out), flush=True)
    return out


def _layer_inputs(net, params, sparse, x, impl: str) -> dict:
    """{layer name: its input} over one forward of ``x``: each conv's
    NHWC input (``net_apply``'s ``collect``) and each FC's (N, din) input
    (recorded around `apply_sparse_fc`)."""
    from unittest import mock

    import torch
    from repro_torch.models import graph as G

    rec: list = []
    fc_in: list = []
    fc_apply = G.apply_sparse_fc

    def record(x, *args, **kw):
        fc_in.append(x)
        return fc_apply(x, *args, **kw)

    with torch.inference_mode(), \
            mock.patch.object(G, "apply_sparse_fc", record):
        G.net_apply(net, params, x, sparse=sparse, impl=impl, collect=rec)
    fcs = [l.name for l in net.layers if isinstance(l, G.FC)]
    if len(fc_in) != len(fcs):
        raise SystemExit(f"chip_smoke: recorded {len(fc_in)} FC inputs for "
                         f"{fcs}")
    return {**{name: xin for name, xin, *_ in rec}, **dict(zip(fcs, fc_in))}


def forward_phase(timer: Timer, path: str, srv, images, dev, *,
                  stack_layers_only: bool = False) -> None:
    """Every sparse layer of one batch-8 forward of the path at its real
    input (``stack_layers_only``: only the layers that run a stack
    kernel, where the path's halo twin times the rest).  On an int8 path
    each layer's input is quantized as the path does it (its scale times
    the layer's weight scales is the kernel's combined scale).  A conv's
    residual is a seeded tensor of the output's shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.models.graph import (Conv, FC,
                                          quantize_activations_int8)

    gen = torch.Generator().manual_seed(1)
    layout = "stack" if srv.backend.apply.impl == "pallas-stack" else "halo"
    x = torch.from_numpy(np.stack(images[:BATCH])).to(dev)
    inputs = _layer_inputs(srv.net, srv.params, srv.sparse, x,
                           srv.backend.apply.impl)

    def quantized(xin, spec):
        """(layer input, quant) as the path's kernel sees it."""
        if spec.scale is None:
            return xin, None
        xq, sx = quantize_activations_int8(xin)
        return xq, (sx, spec.scale)

    for l in srv.net.layers:
        if not isinstance(l, (Conv, FC)):
            continue
        pointwise = isinstance(l, FC) or (l.kh == 1 and l.kw == 1)
        if stack_layers_only and pointwise:
            continue
        label = f"forward {path} {l.name}"
        if isinstance(l, Conv):
            spec = srv.sparse[l.name]
            xin, quant = quantized(inputs[l.name], spec)
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
                               else res.reshape(-1, l.cout), quant=quant)
            elif l.groups == l.cin and l.groups > 1:
                row = _dw_case(timer, label, xin, spec.vs, stride=l.stride,
                               layout=layout, bias=spec.bias, residual=res,
                               relu=l.relu, quant=quant)
            else:
                row = _conv_case(timer, label, xin, spec.vs, kh=l.kh,
                                 stride=l.stride, cin_real=cin_real,
                                 groups=l.groups, layout=layout,
                                 bias=spec.bias, residual=res, relu=l.relu,
                                 quant=quant)
        else:
            spec = srv.sparse[l.name]
            n_enc = spec.vs.shape[1]
            bias = F.pad(spec.bias, (0, n_enc - spec.bias.shape[0]))
            xin, quant = quantized(inputs[l.name], spec)
            row = _mm_case(timer, label, xin, spec.vs,
                           n_real=spec.bias.shape[0], bias=bias, relu=l.relu,
                           quant=quant)
        timer.add(path, row)


def dense_vs_sparse_phase(srv, images, dev) -> dict:
    """The paper's comparison on this card: VGG-16's device ms for one
    batch-8, 224 px forward, summed over its 13 convs and 3 FCs, each at
    its real input, each call timed alone (`_device_ms`):

    (a) density 0.235 (the served weights) with the input-side skip on:
        the served forward;
    (b) the same with ``skip_zero_inputs=False``: the same bits per layer;
    (c) density 1.0 with the skip off: the dense network on the same
        kernels, at its own activations;
    (d) the dense network through cuDNN convs and cuBLAS matmuls, f32,
        TF32 off, bias included (the ReLUs, fused into the kernels, and
        the pools are in none of the four).

    Each sparse call is the dispatch (`kernels.ops`: the halo buffer's
    pad, then the kernel); each cuDNN call pads SAME itself.  Per layer,
    (c) must equal relu?(d) within 1e-5 relative."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core.sparse_ops import same_pads
    from repro_torch.kernels import ops as kops
    from repro_torch.models.graph import FC, Conv

    cfg, net, params = srv.cfg, srv.net, srv.params
    x = torch.from_numpy(np.stack(images[:BATCH])).to(dev)
    dense_sparse, _ = net.sparsify(params, 1.0, vk=cfg.vk, vn=cfg.vn)
    layers = [l for l in net.layers if isinstance(l, (Conv, FC))]

    def sparse_calls(sparse, inputs, skip: bool) -> dict:
        calls = {}
        for l in layers:
            spec, xin = sparse[l.name], inputs[l.name]
            if isinstance(l, Conv):
                xin = F.pad(xin, (0, spec.cin_pad)) if spec.cin_pad else xin
                calls[l.name] = lambda xin=xin, spec=spec, l=l: kops.vsconv(
                    xin, spec.vs, kh=l.kh, kw=l.kw, stride=l.stride,
                    bias=spec.bias, fuse_relu=l.relu, impl="halo",
                    skip_zero_inputs=skip)
            else:
                n_enc = spec.vs.shape[1]
                bias = F.pad(spec.bias, (0, n_enc - spec.bias.shape[0]))
                calls[l.name] = lambda xin=xin, spec=spec, l=l, b=bias: \
                    kops.vsmm(xin, spec.vs, bias=b, fuse_relu=l.relu,
                              skip_zero_inputs=skip)
        return calls

    def library_calls(inputs) -> dict:
        calls = {}
        for l in layers:
            p, xin = params[l.name], inputs[l.name]
            if isinstance(l, Conv):
                _, pt, pb = same_pads(xin.shape[1], l.kh, l.stride)
                _, pl, pr = same_pads(xin.shape[2], l.kw, l.stride)
                xl = F.pad(xin, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
                wl = p["w"].permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                calls[l.name] = lambda xl=xl, wl=wl, b=p["b"], s=l.stride: \
                    F.conv2d(xl, wl, b, s)
            else:
                calls[l.name] = lambda xin=xin, w=p["w"], b=p["b"]: \
                    torch.addmm(b, xin, w)
        return calls

    sparse_in = _layer_inputs(net, params, srv.sparse, x, "auto")
    dense_in = _layer_inputs(net, params, dense_sparse, x, "auto")
    variants = {"a": sparse_calls(srv.sparse, sparse_in, True),
                "b": sparse_calls(srv.sparse, sparse_in, False),
                "c": sparse_calls(dense_sparse, dense_in, False),
                "d": library_calls(dense_in)}
    per_layer = {}
    for l in layers:
        ys = {k: v[l.name]() for k, v in variants.items()}
        torch.cuda.synchronize()
        if not torch.equal(ys["a"], ys["b"]):
            raise SystemExit(f"chip_smoke: VGG-16 {l.name}: skip off "
                             f"differs from skip on")
        ref = ys["d"].permute(0, 2, 3, 1) if ys["d"].dim() == 4 else ys["d"]
        ref = torch.relu(ref) if l.relu else ref
        _check(f"VGG-16 {l.name} density 1.0 kernel vs cuDNN/cuBLAS",
               ys["c"][..., :ref.shape[-1]], ref)
        per_layer[l.name] = {k: _device_ms(v[l.name], 5)
                             for k, v in variants.items()}
    sums = {k: sum(t[k] for t in per_layer.values()) for k in variants}
    out = {"phase": "dense_vs_sparse", "config": cfg.name, "batch": BATCH,
           "image_size": SIZE, "density": srv.density,
           "a_sparse_skip_on_ms": sums["a"],
           "b_sparse_skip_off_ms": sums["b"],
           "c_dense_weights_same_kernels_skip_off_ms": sums["c"],
           "d_dense_cudnn_cublas_f32_ms": sums["d"],
           "c_over_a": sums["c"] / sums["a"],
           "b_over_a": sums["b"] / sums["a"],
           "d_over_a": sums["d"] / sums["a"],
           "paper_vgg16_speedup_over_dense": 1.93,
           "paper_note": "the paper's 1.93x is its own 168-PE array's "
                         "cycle count (density 0.235 vs dense), not this "
                         "card",
           "per_layer_ms": per_layer}
    return out


# kernel -> (CUDA source, the Pallas function it replaces); a "_int8"
# kernel is the int8 branch of the same CUDA kernel and Pallas function
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
SOURCES.update({f"{k}_int8": SOURCES[k] for k in list(SOURCES)})


def int8_instantiations(logs: dict) -> list:
    """One row per int8 kernel instantiation (``vsmm_int8_kernel`` per RT
    and SPLIT and its phase 2 ``vsmm_int8_reduce_kernel``,
    ``vsconv_{halo,stack}_int8_kernel``, the int8 stem bodies
    ``vsconv_{halo,stack}_stem_int8_kernel`` per NC and C,
    ``vsconv_dw_{halo,stack}_int8_kernel`` per VC and VEC) with its
    registers and spill bytes."""
    rows = []
    for source in ("vsmm", "vsconv", "vsconv_dw"):
        for name, use in ptxas_usage(logs[source]).items():
            if source == "vsmm":
                row = _vsmm_row(name)
                if row is not None and row["kernel"].startswith("vsmm_int8"):
                    rows.append({**row, **use})
                continue
            gen = _generic_row(name)
            if gen is not None:
                if gen["kernel"].endswith(("_int8", "_int8_reduce")):
                    rows.append({**gen, **use})
                continue
            m = re.search(r"(vsconv_halo|vsconv_stack|vsconv_dw_halo|"
                          r"vsconv_dw_stack)_(stem_)?int8_kernel"
                          r"(?:ILi(\d+)ELi(\d+)E)?", name)
            if m:
                row = {"kernel": f"{m.group(1)}_{m.group(2) or ''}int8"}
                if m.group(3) and m.group(2):
                    row.update(vn=32 * int(m.group(3)), c=int(m.group(4)))
                elif m.group(3):
                    row.update(vc=int(m.group(3)), vec=int(m.group(4)))
                rows.append({**row, **use})
    return sorted(rows, key=lambda r: tuple(str(v) for v in r.values()))


def _generic_row(name: str) -> dict | None:
    """vsconv.cu's generic-body entry functions, by layout: phase 1 with
    its tile (``rows`` x ``vn`` outputs; f32 ``vsconv_*_kernel<RT, CT,
    kFast>``: 16*RT x 16*CT; int8 ``vsconv_*_int8_kernel<MI, WC, kFast,
    kSplit>``: 8/WC*16*MI x 32*WC), whether it is a fast instantiation
    (vk 32) or the general one, and (int8) whether it keeps split sums;
    and phase 2 (``vsconv_*_reduce_kernel``).  A name without template
    arguments gives the kernel alone."""
    m = re.search(r"(vsconv_halo|vsconv_stack)_(int8_)?(reduce_)?kernel"
                  r"(I(?:L[ib]\d+E)+E)?", name)
    if m is None:
        return None
    row = {"kernel": m.group(1) + ("_int8" if m.group(2) else "")
           + ("_reduce" if m.group(3) else "")}
    args = [int(a) for a in re.findall(r"L[ib](\d+)E", m.group(4) or "")]
    if m.group(2) and len(args) == 4:
        mi, wc, fast, split = args
        row.update(rows=8 // wc * 16 * mi, vn=32 * wc, fast=bool(fast),
                   split=bool(split))
    elif not m.group(2) and len(args) == 3:
        rt, ct, fast = args
        row.update(rows=16 * rt, vn=16 * ct, fast=bool(fast))
    return row


def generic_instantiations(log: str) -> list:
    """One row per instantiation of ``vsconv.cu``'s generic body (f32 and
    int8, both layouts, both phases) with its registers and spill
    bytes."""
    rows = [{**row, **use} for name, use in ptxas_usage(log).items()
            if (row := _generic_row(name)) is not None]
    return sorted(rows, key=lambda r: tuple(str(v) for v in r.values()))


def _vsmm_row(name: str) -> dict | None:
    """vsmm.cu's entry functions: the phase-1 kernels per RT (rows a
    thread) and, for int8, SPLIT; the phase-2 reduce kernels."""
    m = re.search(r"vsmm_(int8_)?(reduce_)?kernel(?:ILi(\d+)E(?:Lb([01])E)?)?",
                  name)
    if m is None:
        return None
    row = {"kernel": "vsmm" + ("_int8" if m.group(1) else "")
           + ("_reduce" if m.group(2) else "")}
    if m.group(3):
        row["rt"] = int(m.group(3))
    if m.group(4):
        row["split"] = m.group(4) == "1"
    return row


def vsmm_instantiations(log: str) -> list:
    """One row per instantiation of ``vsmm.cu`` (f32 and int8, both
    phases) with its registers and spill bytes."""
    rows = [{**row, **use} for name, use in ptxas_usage(log).items()
            if (row := _vsmm_row(name)) is not None]
    return sorted(rows, key=lambda r: tuple(str(v) for v in r.values()))


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
    from repro_torch.launch.serve import ImageRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw, bf16_peak, int8_peak = _peaks(name)

    t0 = time.perf_counter()
    logs = _build.build("vsmm", "vsconv", "vsconv_dw", "flash_fwd")
    build_s = time.perf_counter() - t0
    for kernel, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"built {kernel}: {'; '.join(regs)}")
    flash = flash_instantiations(_build.build_log("flash_fwd"))
    spills = [r for r in flash if r["body"] == "mma" and r["hd"] == 128]
    if len(spills) != 1 or spills[0]["spill_stores"] != 0 or \
            spills[0]["spill_loads"] != 0:
        print(f"chip_smoke: the bf16 hd-128 flash instantiation spills or "
              f"is missing: {spills}", file=sys.stderr)
        return 1
    stencils = stencil_instantiations(_build.build_log("vsconv"),
                                      _build.build_log("vsconv_dw"))
    for r in stencils:
        print(f"built {r}")
    spilled = [r for r in stencils if r["spill_stores"] or r["spill_loads"]
               or r["spill_stores"] is None]
    if len(stencils) != 26 or spilled:
        print(f"chip_smoke: {len(stencils)} stem and depthwise "
              f"instantiations (expected 26: 8 f32 and 8 int8 stem bodies, "
              f"10 dw), spilling or unread: {spilled}", file=sys.stderr)
        return 1
    int8_rows = int8_instantiations(
        {k: _build.build_log(k) for k in ("vsmm", "vsconv", "vsconv_dw")})
    for r in int8_rows:
        print(f"built {r}")
    spilled = [r for r in int8_rows if r["spill_stores"]
               or r["spill_loads"] or r["spill_stores"] is None]
    if len(int8_rows) != 42 or spilled:
        print(f"chip_smoke: {len(int8_rows)} int8 instantiations (expected "
              f"42: vsmm's 5 phase-1 and 1 phase-2 kernels, the generic "
              f"body's 16 phase-1 and 2 phase-2 kernels, 8 stem bodies, 5 "
              f"dw halo, 5 dw stack), spilling or unread: {spilled}",
              file=sys.stderr)
        return 1
    generic_rows = generic_instantiations(_build.build_log("vsconv"))
    for r in generic_rows:
        print(f"built {r}")
    spilled = [r for r in generic_rows if r["spill_stores"]
               or r["spill_loads"] or r["spill_stores"] is None]
    if len(generic_rows) != 30 or spilled:
        print(f"chip_smoke: {len(generic_rows)} generic-body instantiations "
              f"(expected 30: per layout f32 phase 1 at 128 and 64 rows x "
              f"vn 128 and 64 and the general one, int8 phase 1 at 128 and "
              f"64 rows x vn 128 and 64, split at 64 rows x vn 128 and 64, "
              f"the general one whole and split, and phase 2 f32 and int8), "
              f"spilling or unread: {spilled}", file=sys.stderr)
        return 1
    vsmm_rows = vsmm_instantiations(_build.build_log("vsmm"))
    for r in vsmm_rows:
        print(f"built {r}")
    spilled = [r for r in vsmm_rows if r["spill_stores"]
               or r["spill_loads"] or r["spill_stores"] is None]
    if len(vsmm_rows) != 10 or spilled:
        print(f"chip_smoke: {len(vsmm_rows)} vsmm instantiations (expected "
              f"10: f32 phase 1 per RT 2/4/8 and phase 2, int8 phase 1 per "
              f"RT unsplit and RT 2/4 split, and phase 2), spilling or "
              f"unread: {spilled}",
              file=sys.stderr)
        return 1
    lib = _build.load("flash_fwd")
    smem = {body: {hd: lib.flash_fwd_smem_bytes(hd, int(body == "mma"))
                   for hd in (32, 64, 80, 128, 240)}
            for body in ("mma", "simt")}
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "built": sorted(logs),
                      "flash_fwd_instantiations": flash,
                      "stencil_instantiations": stencils,
                      "int8_instantiations": int8_rows,
                      "generic_instantiations": generic_rows,
                      "vsmm_instantiations": vsmm_rows,
                      "flash_fwd_dynamic_smem_bytes_by_hd": smem}),
          flush=True)

    seconds = {"build": build_s}
    clock = [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        seconds[phase] = now - clock[0]
        clock[0] = now

    timer = Timer(peak_flops, peak_bw, int8_peak)
    kernel_phase(timer, dev)
    lap("kernel")
    flash_rows = flash_phase(timer, dev, bf16_peak)
    lap("flash")
    served = {path: serve_phase(path, dev) for path in PATHS}
    lap("serve")
    bucket_mix = {path: bucket_mix_phase(path, served[path], dev)
                  for path in BUCKET_MIX_PATHS}
    lap("bucket_mix")
    profiled = {
        path: profile_phase(
            path, lambda s=s: s["srv"].serve(
                [ImageRequest(rid=i, image=im)
                 for i, im in enumerate(s["images"])]), s["warm_s"],
            int8=PATHS[path][2] == "int8")
        for path, s in served.items()}
    for path, s in served.items():
        s["profile"] = profiled[path]
        s["summary"]["device_idle_share"] = \
            profiled[path]["device_idle_share"]
    lap("profile")
    for path, s in served.items():
        forward_phase(timer, path, s["srv"], s["images"], dev,
                      stack_layers_only=path.replace("-stack", "-halo")
                      in PATHS and path.endswith("-stack"))
    lap("forward")
    fleets = {path: fleet_phase(path, served[path], dev)
              for path in FLEET_PATHS}
    lap("fleet")
    vgg = served["vgg16-halo"]
    dense_vs_sparse = dense_vs_sparse_phase(vgg["srv"], vgg["images"], dev)
    lap("dense_vs_sparse")
    cnn_launches = {path: s["launches"] for path, s in served.items()}
    stem_launches = {path: s["stem_launches"] for path, s in served.items()}
    cnn_summaries = {path: s["summary"] for path, s in served.items()}
    served.clear()  # free the CNN servers before the 4 B-parameter model
    cli = cli_phase()
    lap("cli")

    lm = lm_serve_phase(dev)
    lm_check = lm_check_phase(lm["srv"], lm["reqs"], dev)
    lm_warm = lm_warm_phase(lm["srv"], lm["traffic"])
    lm_decode = lm_decode_phase(lm["srv"], lm["traffic"], dev)
    profiled[LM_CONFIG] = profile_phase(
        LM_CONFIG, lambda: lm["srv"].serve(_lm_requests(lm["traffic"])),
        lm_warm["warm_serve_s"])
    qwen_row = flash_rows[QWEN_PREFILL_CASE]
    breakdown = prefill_breakdown_phase(lm["srv"], qwen_row, dev)
    lap("lm")
    print(json.dumps({"phase": "seconds", **seconds}), flush=True)

    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        s = timer.sums[kname]
        by_path = {path: v[kname] for path, v in cnn_launches.items()
                   if kname in v}
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": timer.max_abs_err[kname], "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": max(s["flops_bound_ms"], s["bytes_bound_ms"]),
            "bound_by": ("operations" if s["flops_bound_ms"]
                         >= s["bytes_bound_ms"] else "bytes"),
            "library_ms": s["library_ms"], "host_loop_ms": s["host_loop_ms"],
        })
        if kname.endswith("_int8"):
            kernels[-1]["library"] = ("f32 cuDNN conv / cuBLAS matmul on "
                                      "the dequantized input and weight")
            for key in ("int_mm_ms", "int_mm_refused_layers"):
                if key in s:
                    kernels[-1][key] = s[key]
        stem = timer.sums.get(f"{kname}:stem")
        if stem is not None:  # the stem body's share of the entry above
            kernels[-1]["stem_body"] = {
                "launches": sum(n for path, n in stem_launches.items()
                                if kname in cnn_launches[path]),
                "ms": stem["ms"], "plain_ms": stem["plain_ms"],
                "bound_ms": max(stem["flops_bound_ms"],
                                stem["bytes_bound_ms"]),
                "library_ms": stem["library_ms"]}
    layers = lm["summary"]["layers"]
    flash_bound = {k: layers * qwen_row[f"{k}_bound_ms"]
                   for k in ("flops", "bytes")}
    kernels.append({
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash.py:92",
        "launches": lm["launches"]["flash_fwd"],
        "launches_by_path": {LM_CONFIG: lm["launches"]["flash_fwd"]},
        "max_abs_err": timer.max_abs_err["flash_fwd"],
        "ms": layers * qwen_row["kernel_ms"],
        "plain_ms": layers * qwen_row["plain_ms"],
        "bound_ms": max(flash_bound.values()),
        "bound_by": ("operations" if flash_bound["flops"]
                     >= flash_bound["bytes"] else "bytes"),
        "library_ms": layers * qwen_row["library_ms"],
        "per": f"one Qwen1.5-4B prefill, batch {LM_BATCH}, T 512, bf16 "
               f"({layers} launches)",
        "ms_per_launch": qwen_row["kernel_ms"], "body": qwen_row["body"],
    })
    result = {"kernels": kernels}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"gpu": smi, "result": result, "per_forward": timer.sums,
             "per_forward_by_path": timer.by_path,
             "serve": cnn_summaries, "bucket_mix": bucket_mix,
             "fleet": fleets, "cli": cli,
             "flash": flash_rows,
             "lm": {"serve": lm["summary"], "check": lm_check,
                    "warm": lm_warm, "decode": lm_decode,
                    "prefill_breakdown": breakdown},
             "profile": profiled, "dense_vs_sparse": dense_vs_sparse,
             "seconds": seconds},
            indent=1))
    print(json.dumps({k: v for k, v in dense_vs_sparse.items()
                      if k != "per_layer_ms"}))
    print(smi)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
