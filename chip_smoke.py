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
   one must not spill), of each of the 18 stem-body and depthwise
   instantiations and of the 13 int8 instantiations (vsmm, the halo and
   stack convs' generic body, 5 dw halo, 5 dw stack; none of these 31 may
   spill), and the flash kernel's dynamic shared memory per head dim and
   body.
2. Kernel phase.  Each kernel against its plain version on the card,
   within a relative error of 1e-5 of max|y| (1e-2 for the flash kernel
   on bf16 inputs), then timed (see below).  One JSON line per case.  The
   CNN kernels at batch 8, 224 px geometries, each case without and with
   the fused epilogue (bias + residual + ReLU):
   - halo conv: the ResNet-18 layers (stem 7x7/s2 vk 8; 3x3/s1 at 56;
     3x3/s2 64->128; 3x3 512->512 at Hout 7) and one Hout < 4 conv
     (layer4 at 32 px); vsmm: the 1x1/s2 projection and the FC head;
   - depthwise halo: MobileNetV1's dw1 (112, C 32), dw2 (112 -> 56, C 64),
     dw7 (14, C 512), dw12 (14 -> 7, C 512), dw13 (7, C 1024);
   - stack conv: the ResNet-18 stem 7x7/s2, a 3x3/s1 at 56, a 3x3/s2
     64->128;
   - both layouts: the MobileNetV1 stem 3x3/s2 cin 3 -> 8 -> 32, a 7x7/s2
     stem at 227 px (Hout 114, which cuts the stem body's 8 x 16 tiles),
     one grouped 3x3 (64 -> 64, groups 4, 56 px);
   - depthwise stack: dw1, dw2 and dw12.
   Each conv row names its body (``"stem"`` where `use_stem_body` holds,
   else ``"generic"``).
   The int8 branches (`int8_kernel_cases`), each bit-equal to its plain
   version (max|Δ| 0), without and with the epilogue, on int8 tiles and
   activations quantized on the card: the halo and the stack conv at the
   ResNet-18 stem (the generic body: int8 never takes the stem body),
   3x3/s1 at 56, 3x3/s2 64->128, 3x3 512->512 at Hout 7 and the Hout < 4
   case; vsmm at the 1x1/s2 projection and the FC head; the dw halo and
   dw stack at dw1, dw2, dw12.
   The dense-input mode (`skip_cases`): every kernel and branch (f32 and
   int8 generic bodies and the f32 stem body in both layouts, at 3x3/s1
   56 px and VGG-16's conv1; both dw kernels at dw2; vsmm at the 1x1/s2
   projection) with ``skip_zero_inputs=False`` on a post-ReLU input whose
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
   224x224x3 requests; the counts are read just after and must be exactly
   the path's per-wave launches times the waves:
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
     launches.
   Each f32 path must run the stem body exactly once a wave (the
   wrappers' ``stem_launches``), each int8 path never (its stems take the
   generic body), and every launch of an int8 path must be of an int8
   branch (``int8_launches``), none of an f32 path.
   Every request must be delivered, finite, and equal to a direct
   ``net_apply(impl="plain")`` on the card within 1e-5 (f32) or bit for
   bit (int8).  The halo paths then serve their traffic again, warm:
   images/s and ms per wave.
4. Profile.  One more warm serve of each halo path under
   `torch.profiler`: the device's busy time and idle share over that
   serve, and device time by kind.  The busy time over the unprofiled warm
   serve's wall clock is printed too, named as the estimate from two
   serves that it is.
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
   phases summed over the paths (per path in ``launches_by_path``).  The
   ``vsconv_halo`` and ``vsconv_stack`` entries carry ``stem_body``: the
   stem layers' share (launches, ms, plain, bound and library ms).
   Then the paper's dense-versus-sparse comparison on VGG-16
   (`dense_vs_sparse_phase`): device ms of a batch-8 forward summed over
   its layers at their real inputs, (a) as served (density 0.235, skip
   on), (b) skip off, (c) density 1.0 on the same kernels, skip off, (d)
   the dense net on cuDNN/cuBLAS f32; printed on one line before the
   card's line.
6. LM serve phase.  The port's ``Server(get_config("qwen1.5-4b"),
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
   exactly the tokens the server delivered.  The traffic is served again
   warm (prefill seconds per run, decode tokens/s, ms per decode step),
   once more under `torch.profiler` (idle share, device time by kind:
   flash kernel, GEMMs, copies, other), and one batch-8, T-512 prefill is
   broken down into the flash kernel's share (per layer x 40: device,
   plain, library and bound ms) and the rest.  The ``kernels`` line's
   flash entry is per such prefill (40 launches); ``launches`` is the
   serve phase's count.

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
    import torch
    from repro_torch.models.graph import quantize_weights_int8, weight_scales

    w, mask = _pruned(gen, kh, cin, cout, vk, vn, density)
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
    shape (``int_mm_ms``; else null and ``int_mm_refused``)."""
    import torch
    from repro_torch.core.vector_sparse import decode
    from repro_torch.kernels.vsmm import vsmm_kernel, vsmm_plain

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
    int8_kernel_cases(timer, dev, gen, act, epilogue)
    skip_cases(timer, dev, gen, act)


def int8_kernel_cases(timer: Timer, dev, gen, act, epilogue) -> None:
    """The int8 branch of each kernel on the main int8 paths, at the f32
    cases' 224 px geometries, in both layouts, without and with the
    epilogue: int8 tiles and activations quantized on the card as the int8
    path does, each kernel bit-equal to its plain version.  The stems run
    the generic body in int8."""
    import torch
    from repro_torch.models.graph import quantize_activations_int8

    conv_cases = [  # label, H, cin, cout, kh, stride, vk, vn, density
        ("stem 7x7/s2 224px cin 3->8", 224, 8, 64, 7, 2, 8, 64, 1.0),
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
    input is post-ReLU and its first image (vsmm: its first 32 rows) is
    all zero, so the skip-on kernel skips whole tiles.  The skip-off
    output must have the skip-on bits (`_skip_extra`) and equal the plain
    version (bit for bit in int8); both are timed."""
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
    """One row per instantiation of the stem bodies (``vsconv.cu``: vn =
    32 x NC, C input channels) and of the depthwise bodies
    (``vsconv_dw.cu``: VC, 0 for any runtime vc, and VEC floats a copy),
    with their registers and spill bytes."""
    rows = []
    for name, use in ptxas_usage(conv_log).items():
        if m := re.search(r"vsconv_(halo|stack)_stem_kernelILi(\d+)ELi(\d+)E",
                          name):
            rows.append({"kernel": f"vsconv_{m.group(1)}_stem",
                         "vn": 32 * int(m.group(2)), "c": int(m.group(3)),
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
    from repro_torch.kernels.flash import flash_fwd_kernel
    from repro_torch.kernels.vsconv import (vsconv_halo_kernel,
                                            vsconv_stack_kernel)
    from repro_torch.kernels.vsconv_dw import (vsconv_dw_halo_kernel,
                                               vsconv_dw_stack_kernel)
    from repro_torch.kernels.vsmm import vsmm_kernel
    return {"vsconv_halo": vsconv_halo_kernel, "vsmm": vsmm_kernel,
            "vsconv_dw_halo": vsconv_dw_halo_kernel,
            "vsconv_stack": vsconv_stack_kernel,
            "vsconv_dw_stack": vsconv_dw_stack_kernel,
            "flash_fwd": flash_fwd_kernel}


# path -> (config, impl, dtype, requests, launches per wave, stem-body
# launches per wave, warm re-serve).  The int8 paths launch the int8
# branches only (their launches are filed under "<kernel>_int8"), and their
# stems take the generic body.
PATHS = {
    "resnet18-halo": ("vscnn-resnet18", "auto", None, 16,
                      {"vsconv_halo": 17, "vsmm": 4}, 1, True),
    "mobilenet_v1-halo": ("vscnn-mobilenet-v1", "auto", None, 16,
                          {"vsconv_halo": 1, "vsconv_dw_halo": 13,
                           "vsmm": 14}, 1, True),
    "resnet18-int8-halo": ("vscnn-resnet18", "auto", "int8", 16,
                           {"vsconv_halo_int8": 17, "vsmm_int8": 4}, 0,
                           True),
    "mobilenet_v1-int8-halo": ("vscnn-mobilenet-v1", "auto", "int8", 16,
                               {"vsconv_halo_int8": 1,
                                "vsconv_dw_halo_int8": 13,
                                "vsmm_int8": 14}, 0, True),
    "mobilenet_v1-stack": ("vscnn-mobilenet-v1", "pallas-stack", None, BATCH,
                           {"vsconv_stack": 1, "vsconv_dw_stack": 13,
                            "vsmm": 14}, 1, False),
    "resnet18-stack": ("vscnn-resnet18", "pallas-stack", None, BATCH,
                       {"vsconv_stack": 17, "vsmm": 4}, 1, False),
    "resnet18-int8-stack": ("vscnn-resnet18", "pallas-stack", "int8", BATCH,
                            {"vsconv_stack_int8": 17, "vsmm_int8": 4}, 0,
                            False),
    "mobilenet_v1-int8-stack": ("vscnn-mobilenet-v1", "pallas-stack", "int8",
                                BATCH, {"vsconv_stack_int8": 1,
                                        "vsconv_dw_stack_int8": 13,
                                        "vsmm_int8": 14}, 0, False),
    "vgg16-halo": ("vscnn-vgg16", "auto", None, 16,
                   {"vsconv_halo": 13, "vsmm": 3}, 1, True),
    "vgg16-int8-stack": ("vscnn-vgg16", "pallas-stack", "int8", BATCH,
                         {"vsconv_stack_int8": 13, "vsmm_int8": 3}, 0,
                         False),
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

    name, impl, dtype, n_req, per_wave, stem_per_wave, warm = PATHS[path]
    int8 = dtype == "int8"
    cfg = get_config(name)
    t0 = time.perf_counter()
    srv = CNNServer(cfg, batch=BATCH, impl=impl, dtype=dtype, seed=0,
                    device=dev)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(n_req)]

    def requests():
        return [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]

    reqs = requests()
    counters = _counters()
    stems = [k for k in counters.values() if hasattr(k, "stem_launches")]
    int8s = [k for k in counters.values() if hasattr(k, "int8_launches")]
    for k in counters.values():
        k.launches = 0
    for k in stems:
        k.stem_launches = 0
    for k in int8s:
        k.int8_launches = 0
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
    delivered = [r for r in reqs if r.outcome is not None
                 and r.outcome.status == "delivered"]
    if len(delivered) != n_req:
        raise SystemExit(f"chip_smoke: {path}: {len(delivered)}/{n_req} "
                         f"delivered")
    expected = {k: v * waves for k, v in per_wave.items()}
    if launches != expected:
        raise SystemExit(f"chip_smoke: {path}: launches {launches} over "
                         f"{waves} waves, expected {per_wave} per wave")
    if stem_launches != stem_per_wave * waves:
        raise SystemExit(f"chip_smoke: {path}: the stem body ran "
                         f"{stem_launches} times over {waves} waves, "
                         f"expected {stem_per_wave} a wave")
    if int8_launches != ({n: k.launches for n, k in counters.items()
                          if k.launches} if int8 else {}):
        raise SystemExit(f"chip_smoke: {path}: int8 branch launches "
                         f"{int8_launches} of launches {launches}")
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
        "waves": waves, "launches": launches,
        "stem_launches": stem_launches, "setup_s": setup_s,
        "first_serve_s": serve_s, "first_images_per_s": n_req / serve_s,
        "served_vs_plain_rel_err": rel,
        "served_vs_plain_bit_equal": bool(np.array_equal(served,
                                                         ref.numpy())),
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
            "stem_launches": stem_launches, "warm_s": warm_s,
            "summary": out}


def _kind(name: str) -> str:
    for kind in ("vsconv_dw_halo", "vsconv_dw_stack", "vsconv_halo",
                 "vsconv_stack", "vsmm", "flash_fwd"):
        if f"{kind}_int8_kernel" in name:
            return f"{kind}_int8"
        if f"{kind}_kernel" in name or f"{kind}_stem_kernel" in name:
            return kind   # a stem body is filed under its kernel
    if "flash_mma_kernel" in name or "flash_simt_kernel" in name:
        return "flash_fwd"   # the flash kernel's bf16 and f32 bodies
    if "Memcpy" in name or "Memset" in name:
        return "copy"
    if any(key in name for key in ("gemm", "nvjet", "xmma", "cutlass",
                                   "splitK")):
        return "gemm"
    return "other"


def profile_phase(path: str, serve, warm_s: float) -> dict:
    """One more warm serve of the path's traffic (``serve()``) under
    `torch.profiler`: the device's busy time (the union of its kernel and
    copy intervals) against the wall clock of the same serve, and device
    time by kind.  The profiler's own host overhead lengthens the wall
    clock, so that idle share is an upper bound.  The busy time over
    ``warm_s``, the wall clock of the earlier unprofiled serve of the same
    traffic, is printed as an estimate built from two serves.  A trace
    without device events reports nulls (not measured) instead of
    numbers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
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
    for k in counters.values():
        k.launches = 0
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
    out = {"phase": "serve", "path": LM_CONFIG, "config": cfg.name,
           "layers": cfg.total_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "dtype": cfg.param_dtype, "batch": LM_BATCH,
           "capacity": LM_CAPACITY, "requests": len(reqs),
           "delivered": len(delivered), "launches": launches,
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
    """One row per int8 kernel instantiation (``vsmm_int8_kernel``,
    ``vsconv_{halo,stack}_int8_kernel``, ``vsconv_dw_{halo,stack}_int8_
    kernel`` per VC and VEC) with its registers and spill bytes."""
    rows = []
    for source in ("vsmm", "vsconv", "vsconv_dw"):
        for name, use in ptxas_usage(logs[source]).items():
            m = re.search(r"(vsmm|vsconv_halo|vsconv_stack|vsconv_dw_halo|"
                          r"vsconv_dw_stack)_int8_kernel"
                          r"(?:ILi(\d+)ELi(\d+)E)?", name)
            if m:
                row = {"kernel": f"{m.group(1)}_int8"}
                if m.group(2):
                    row.update(vc=int(m.group(2)), vec=int(m.group(3)))
                rows.append({**row, **use})
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
    if len(stencils) != 18 or spilled:
        print(f"chip_smoke: {len(stencils)} stem and depthwise "
              f"instantiations (expected 18), spilling or unread: "
              f"{spilled}", file=sys.stderr)
        return 1
    int8_rows = int8_instantiations(
        {k: _build.build_log(k) for k in ("vsmm", "vsconv", "vsconv_dw")})
    for r in int8_rows:
        print(f"built {r}")
    spilled = [r for r in int8_rows if r["spill_stores"]
               or r["spill_loads"] or r["spill_stores"] is None]
    if len(int8_rows) != 13 or spilled:
        print(f"chip_smoke: {len(int8_rows)} int8 instantiations (expected "
              f"13: vsmm, the halo and stack convs, 5 dw halo, 5 dw stack), "
              f"spilling or unread: {spilled}", file=sys.stderr)
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
                      "flash_fwd_dynamic_smem_bytes_by_hd": smem}),
          flush=True)

    timer = Timer(peak_flops, peak_bw, int8_peak)
    kernel_phase(timer, dev)
    flash_rows = flash_phase(timer, dev, bf16_peak)
    served = {path: serve_phase(path, dev) for path in PATHS}
    profiled = {
        path: profile_phase(
            path, lambda s=s: s["srv"].serve(
                [ImageRequest(rid=i, image=im)
                 for i, im in enumerate(s["images"])]), s["warm_s"])
        for path, s in served.items() if s["warm_s"] is not None}
    for path, s in served.items():
        forward_phase(timer, path, s["srv"], s["images"], dev,
                      stack_layers_only=path.replace("-stack", "-halo")
                      in PATHS and path.endswith("-stack"))
    vgg = served["vgg16-halo"]
    dense_vs_sparse = dense_vs_sparse_phase(vgg["srv"], vgg["images"], dev)
    cnn_launches = {path: s["launches"] for path, s in served.items()}
    stem_launches = {path: s["stem_launches"] for path, s in served.items()}
    cnn_summaries = {path: s["summary"] for path, s in served.items()}
    served.clear()  # free the CNN servers before the 4 B-parameter model

    lm = lm_serve_phase(dev)
    lm_check = lm_check_phase(lm["srv"], lm["reqs"], dev)
    lm_warm = lm_warm_phase(lm["srv"], lm["traffic"])
    profiled[LM_CONFIG] = profile_phase(
        LM_CONFIG, lambda: lm["srv"].serve(_lm_requests(lm["traffic"])),
        lm_warm["warm_serve_s"])
    qwen_row = flash_rows[QWEN_PREFILL_CASE]
    breakdown = prefill_breakdown_phase(lm["srv"], qwen_row, dev)

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
             "serve": cnn_summaries,
             "flash": flash_rows,
             "lm": {"serve": lm["summary"], "check": lm_check,
                    "warm": lm_warm, "prefill_breakdown": breakdown},
             "profile": profiled, "dense_vs_sparse": dense_vs_sparse},
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
