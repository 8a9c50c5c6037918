"""vsmm — the vector-sparse matmul: CUDA kernel, wrapper, plain version.

The kernel (``csrc/vsmm.cu``) replaces the JAX package's Pallas kernel
`repro/kernels/vsmm.py::vsmm_pallas`: x (M, K) @ vector-sparse W (K, N), only
the stored (vk, vn) tiles multiplied (the weight-side skip), all-zero
activation tiles skipped at run time (the input-side skip), and the
epilogue x scale -> + bias -> + residual -> ReLU fused at the end.

`vsmm_plan` cuts the work from the shapes alone: a row tile of 8, 32,
64 or 128 rows and ``splits`` contiguous chunks of each strip's stored
steps, so that a few rows (an FC head at batch 8) still give every SM
work.  With ``splits > 1`` the kernel runs in two phases on the current
stream: each (strip, chunk) block writes its chunk's partial of its row
tiles to a workspace (allocated here, no host sync), and a second launch
combines the chunks in chunk order and applies the epilogue, so the
output has the same bits from run to run.

The kernel has an f32 branch and an int8 one (int8 x and tiles, a
per-column dequant scale; the reference's `_mac_dot` on int8): each
stored step's int8 x int8 partial is an exact integer, and the result is
bit-equal to the reference's and to `vsmm_plain`, whose f32 accumulator
takes the partials in stored order: the kernel adds them in that order
where a block holds all of a strip's steps, and otherwise combines each
chunk's exact integer sum, recomputing in stored order any element whose
sums might pass 2^24 (see ``csrc/vsmm.cu``).

`vsmm_kernel` is the wrapper: it launches the kernel for CUDA tensors and
runs `vsmm_plain` for CPU tensors, and nothing else — a CUDA tensor that
the kernel does not take raises, it never falls back.
``skip_zero_inputs=False`` (the reference's flag, the paper's dense-input
mode) turns the input-side skip off: every stored step's MAC runs, and
the output has the same bits (a skipped step adds exact zeros).
``vsmm_kernel.launches`` counts wrapper calls that launch the kernel (one
a layer, whatever the split), ``int8_launches`` those of the int8 branch
among them.
"""
from __future__ import annotations

import torch

from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels._build import launch

__all__ = ["vsmm_kernel", "vsmm_plain", "vsmm_kernel_cost", "vsmm_plan",
           "min_chunk", "chunk_bounds", "MAX_VN", "check_operands", "check_epilogue",
           "entry_name", "SMS", "TARGET_BLOCKS", "SMALL_TARGET_BLOCKS",
           "MIN_CHUNK", "ROW_TILES"]

MAX_VN = 128  # the kernel's thread layout covers at most 128 columns

# The plan's constants: an H100's SMs; the blocks a split launch aims at,
# at most (two an SM; four an SM for 8-row tiles, whose blocks are small
# and bound by the bytes of the stored tiles); the fewest stored steps a
# chunk takes (one in 8-row tiles, where a block's chain of steps, not the
# partials, is what costs); the row tiles (128 rows only for strips of at
# most 64 columns: 256 threads of 8 x 4).
SMS = 132
TARGET_BLOCKS = 2 * SMS
SMALL_TARGET_BLOCKS = 4 * SMS
MIN_CHUNK = 2
ROW_TILES = (8, 32, 64, 128)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def min_chunk(rows: int) -> int:
    """The fewest stored steps a chunk of a ``rows``-row tile takes."""
    return 1 if rows == 8 else MIN_CHUNK


def vsmm_plan(m: int, nb: int, s_steps: int, vk: int, vn: int,
              int8: bool = False) -> tuple[int, int]:
    """(rows, splits) of the CUDA kernel for x (m, K) @ W with NB strips of
    S stored (vk, vn) tiles: a pure function of the shapes.

    rows: 8 for m <= 8, 32 for m <= 32, else the largest of 128 (vn <= 64
    only), 64, 32 whose row tiles x NB reach TARGET_BLOCKS; where none
    does, f32 takes 64 if the steps can be split, else 32, and int8 takes
    64 where its row tiles x NB reach 3/4 of the SMs, else 32.  splits: as
    many chunks of at least `min_chunk` steps as keep the blocks within
    the target (SMALL_TARGET_BLOCKS for 8-row tiles), so 1 where the row
    tiles x NB come within a factor 2 of it.  int8 splits only for m <= 32: its
    chunk partials are 8 bytes an element, which cost more than the split
    gains at larger m; and never where a chunk's exact int32 sum could
    overflow (128^2 * vk * S >= 2^31)."""
    if m <= 8:
        rows = 8
    elif m <= 32:
        rows = 32
    else:
        fits = [r for r in (128, 64, 32) if (r < 128 or vn <= 64)
                and _cdiv(m, r) * nb >= TARGET_BLOCKS]
        if fits:
            rows = fits[0]
        elif int8:
            rows = 64 if _cdiv(m, 64) * nb >= SMS * 3 // 4 else 32
        else:
            rows = 64 if s_steps >= 2 * MIN_CHUNK else 32
    target = SMALL_TARGET_BLOCKS if rows == 8 else TARGET_BLOCKS
    splits = max(1, min(target // (_cdiv(m, rows) * nb),
                        s_steps // min_chunk(rows)))
    if int8 and (m > 32 or 128 * 128 * vk * s_steps >= 2 ** 31):
        splits = 1
    return rows, splits


def chunk_bounds(s_steps: int, splits: int) -> list[tuple[int, int]]:
    """The stored steps [s0, s1) of each chunk, as the kernel cuts them:
    chunk c takes [S*c // splits, S*(c+1) // splits)."""
    return [(s_steps * c // splits, s_steps * (c + 1) // splits)
            for c in range(splits)]


def vsmm_kernel_cost(
    *, m: int, nb: int, s_steps: int, vk: int, vn: int, in_itemsize: int = 4,
    w_itemsize: int = 4, out_itemsize: int = 4, residual_bytes: int = 0,
) -> dict[str, int]:
    """Cost model of the reference's TPU kernel, kept for cost tooling:
    every sparse step gathers a fresh (m, vk) activation K-tile, the stored
    weight tiles stream once, the output strip is written once.  It counts
    padding columns and per-strip re-reads, so it is not the least work of
    the function (``chip_smoke.py`` computes that bound itself)."""
    return {
        "flops": 2 * m * nb * s_steps * vk * vn,
        "bytes_accessed": (
            m * nb * s_steps * vk * in_itemsize
            + nb * s_steps * vk * vn * w_itemsize
            + m * nb * vn * out_itemsize
            + residual_bytes
        ),
    }


def _epilogue(y: torch.Tensor, *, bias: torch.Tensor | None,
              residual: torch.Tensor | None, scale: torch.Tensor | None,
              fuse_relu: bool) -> torch.Tensor:
    """acc -> *scale -> +bias -> +residual -> max(0), in f32."""
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    if fuse_relu:
        y = torch.clamp_min(y, 0.0)
    return y


def vsmm_plain(
    x: torch.Tensor,
    vs: VectorSparse,
    *,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: x (M, K) @ W -> (M, N).

    The structural gather + batched product of the reference's
    `vs_matmul(impl="jnp")`: step s gathers every strip's activation K-tile
    idx[:, s] and multiplies it by that strip's stored tile, into an f32
    accumulator, step after step in stored order.  Runs on any device.

    int8 ``x`` and ``vs.vals`` (with a ``scale``): each step's partial is
    an f32 product of int8 values, exact (every partial sum is an integer
    below 127² * vk < 2^24 for vk <= 1040, whatever order the product
    sums in), so it equals the reference's int32 partial; the output is
    f32.  It never skips (``skip_zero_inputs`` is taken for the kernel's
    signature).
    """
    del skip_zero_inputs
    m, k = x.shape
    nb, s_steps, vk, vn = vs.vals.shape
    x3 = x.float().reshape(m, k // vk, vk)
    vals = vs.vals.float()
    idx = vs.idx.long()
    acc = torch.zeros((m, nb, vn), dtype=torch.float32, device=x.device)
    for s in range(s_steps):
        xg = x3[:, idx[:, s]]  # (M, NB, vk)
        acc += torch.einsum("mjk,jkn->mjn", xg, vals[:, s])
    y = _epilogue(acc.reshape(m, nb * vn), bias=bias, residual=residual,
                  scale=scale, fuse_relu=fuse_relu)
    return y if x.dtype == torch.int8 else y.to(x.dtype)


def check_operands(named: dict[str, torch.Tensor | None],
                   device: torch.device) -> bool:
    """Raise unless every given tensor is a contiguous tensor on ``device``
    of the dtype the CUDA kernels take: int32 ``idx``, float32 for the
    rest, except int8 ``x`` and ``vals`` together with a ``scale`` (the
    int8 entries).  Returns True for the int8 entries."""
    int8 = named["x"].dtype == torch.int8
    if int8 and named.get("scale") is None:
        raise ValueError("int8 operands need a dequant scale")
    for name, t in named.items():
        if t is None:
            continue
        want = (torch.int32 if name == "idx"
                else torch.int8 if int8 and name in ("x", "vals")
                else torch.float32)
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes a contiguous {want} tensor on "
                f"{device}, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    return int8


def entry_name(fn: str, int8: bool) -> str:
    """The extern "C" launch entry of a kernel's int8 branch
    (``<kernel>_int8_launch``) or its f32 one (``fn``)."""
    return fn.replace("_launch", "_int8_launch") if int8 else fn


def check_epilogue(*, bias: torch.Tensor | None,
                   scale: torch.Tensor | None,
                   residual: torch.Tensor | None, cout: int,
                   out_shape: tuple[int, ...]) -> None:
    """Raise unless ``bias``/``scale`` are (cout,) and ``residual`` has the
    output's shape."""
    for name, t, shape in (("bias", bias, (cout,)), ("scale", scale, (cout,)),
                           ("residual", residual, out_shape)):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, expected {shape}")


def vsmm_kernel(
    x: torch.Tensor,
    vs: VectorSparse,
    *,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    fuse_relu: bool = False,
    skip_zero_inputs: bool = True,
) -> torch.Tensor:
    """x (M, K) @ vector-sparse W (K, N) -> (M, N) f32, epilogue fused.

    CUDA tensors launch ``csrc/vsmm.cu`` on the current stream (built at
    first use), cut by `vsmm_plan` (two launches where it splits the
    stored steps); CPU tensors run `vsmm_plain`.  ``bias``/``scale`` are (N,),
    ``residual`` (M, N).  Any M works: the kernel masks the ragged tail.
    int8 ``x`` and ``vs.vals`` with a ``scale`` launch the int8 branch
    (counted on ``int8_launches`` too).  ``skip_zero_inputs=False`` turns
    the input-side skip off.
    """
    if x.device.type == "cpu":
        return vsmm_plain(x, vs, bias=bias, residual=residual, scale=scale,
                          fuse_relu=fuse_relu)
    if x.device.type != "cuda":
        raise ValueError(f"vsmm_kernel runs on cuda or cpu, not {x.device}")
    m, k = x.shape
    nb, s_steps, vk, vn = vs.vals.shape
    n = nb * vn
    if vs.shape != (k, n) or k % vk:
        raise ValueError(f"x {tuple(x.shape)} does not match W {vs.shape} "
                         f"with tiles ({vk}, {vn})")
    if vn > MAX_VN:
        raise ValueError(f"vsmm_kernel takes vn <= {MAX_VN}, got {vn}")
    check_epilogue(bias=bias, scale=scale, residual=residual, cout=n,
                   out_shape=(m, n))
    int8 = check_operands({"x": x, "vals": vs.vals, "idx": vs.idx,
                           "bias": bias, "scale": scale,
                           "residual": residual}, x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    rows, splits = vsmm_plan(m, nb, s_steps, vk, vn, int8)
    work = None
    if splits > 1:  # each chunk's partial: f32, or int8's (T_c, A_c) pair
        work = torch.empty((splits, m, n, 2) if int8 else (splits, m, n),
                           dtype=torch.int32 if int8 else torch.float32,
                           device=x.device)
    launch("vsmm", entry_name("vsmm_launch", int8),
           (x, vs.vals, vs.idx, scale, bias, residual, out, work),
           (m, k, nb, s_steps, vk, vn, int(fuse_relu),
            int(skip_zero_inputs), splits, rows), x.device)
    vsmm_kernel.launches += 1
    vsmm_kernel.int8_launches += int(int8)
    return out


vsmm_kernel.launches = 0  # type: ignore[attr-defined]
vsmm_kernel.int8_launches = 0  # type: ignore[attr-defined]
