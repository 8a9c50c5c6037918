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

The kernel has an f32 branch, a bf16 one and an int8 one.  The bf16 one
(bf16 x and tiles, the LM's vector-sparse FFN; the reference's `_mac_dot`
on bf16, ``jnp.dot(x, w, preferred_element_type=f32)``) runs on the tensor
cores (``mma.sync`` m16n8k16, f32 accumulate), cut by `vsmm_bf16_plan`:
at M <= 32 (a decode step) the swapped product W^T x^T, bound by the
stored tiles' bytes, split where the strips do not fill the card; at
M > 32 (a prefill) 64-row tiles of x, bound by the tensor cores.  Each
bf16 product is exact in f32; a fresh mma chain per 32 k is added to f32
accumulators, so the sum is f32 in stored order up to the tensor cores'
rounding inside 32 products.  vk and vn are padded with zeros in shared
memory to multiples of 16 (Qwen1.5-4B's merged ``wo`` has vk 27, its
``wi`` vn 108); rows of x that are only 2-byte aligned (vk 27) are
copied as the 16-byte units that span them and shifted in shared
memory, not padded here.  The int8 branch (int8 x and tiles, a
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
``out_dtype`` is the reference's: the output's dtype, f32 by default for
int8 operands and x's dtype otherwise; the kernel writes it (f32, or its
f32 result rounded to bf16).
``vsmm_kernel.launches`` counts wrapper calls that launch the kernel (one
a layer, whatever the split), ``int8_launches`` and ``bf16_launches``
those of the int8 and the bf16 branch among them.  The kernel is the
custom op ``repro_torch::vsmm`` (`torch.library`), so the dispatcher sees
each call as one op: its CUDA implementation plans, allocates the
workspace and launches, its CPU one is `vsmm_plain`, and its fake (meta)
one states the output's shape and dtype; the dry run counts it by
`vsmm_kernel_cost`, with the workspace of a split plan live for the
launch (`utils.cost`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.device import card_path
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels._build import launch
from repro_torch.utils.cost import register_kernel_cost

__all__ = ["vsmm_kernel", "vsmm_plain", "vsmm_kernel_cost", "vsmm_plan",
           "vsmm_bf16_plan", "min_chunk", "chunk_bounds", "MAX_VN",
           "check_operands", "check_epilogue", "entry_name", "SMS",
           "TARGET_BLOCKS", "SMALL_TARGET_BLOCKS", "MIN_CHUNK", "ROW_TILES",
           "BF16_ROW_TILES", "BF16_DECODE_ITEMS", "BF16_DECODE_MIN_CHUNK",
           "BF16_PREFILL_MIN_CHUNK", "vsmm_x_index_map", "vsmm_w_index_map",
           "vsmm_out_index_map", "vsmm_bias_index_map"]

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


# The bf16 plan's constants (the tensor-core body): its row tiles (8, 16
# and 32 rows on the decode tiling, 64 on the prefill one); the most
# (strip, chunk) items a decode launch splits into: the blocks the card
# holds at once at 8 rows (5 an SM; a step's copies, vote and MAC cost a
# block more than its tile's bytes take to arrive, so the stored tiles
# stream fastest with every block at work on chunks of few steps); the
# fewest stored steps a decode chunk and a prefill chunk take.
BF16_ROW_TILES = (8, 16, 32, 64)
BF16_DECODE_ITEMS = 5 * SMS
BF16_DECODE_MIN_CHUNK = 2
BF16_PREFILL_MIN_CHUNK = 4


def vsmm_bf16_plan(m: int, nb: int, s_steps: int, vk: int,
                   vn: int) -> tuple[int, int]:
    """(rows, splits) of the bf16 body for x (m, K) @ W with NB strips of
    S stored (vk, vn) tiles: a pure function of the shapes.

    m <= 32, the decode tiling (the swapped product W^T x^T: the strip's
    columns on the mma's 16-row side, the rows on its 8-wide side): rows
    8, 16 or 32, the least multiple of 8 (16 past 8) that holds m; splits,
    as many chunks of at least BF16_DECODE_MIN_CHUNK steps as keep the
    items NB x splits within BF16_DECODE_ITEMS (1 where NB alone comes
    within a factor 2 of it: Nemotron-4's ``wi`` has 576 strips; Qwen1.5-
    4B's 64 take 9).  m > 32, the prefill tiling
    (x as the mma's A operand): 64 rows (on the H100 it beat 128-row tiles
    at every FFN shape, the 128-row body needing more registers than two
    blocks an SM leave); splits 1 where the row tiles x NB reach SMS, else
    the fewest chunks of at least BF16_PREFILL_MIN_CHUNK steps that reach
    TARGET_BLOCKS.  ``vk`` and ``vn`` (every vk, vn <= 128 works) do not
    move the plan."""
    del vk, vn
    if m <= 32:
        rows = 8 if m <= 8 else 16 if m <= 16 else 32
        return rows, max(1, min(BF16_DECODE_ITEMS // nb,
                                s_steps // BF16_DECODE_MIN_CHUNK))
    rows = 64
    items = _cdiv(m, rows) * nb
    if items >= SMS:
        return rows, 1
    return rows, max(1, min(_cdiv(TARGET_BLOCKS, items),
                            s_steps // BF16_PREFILL_MIN_CHUNK))


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


# The reference's block index maps, grid (j, mi, s) = (output strip,
# row-block, sparse step): plain integer functions of the layout contract
# that vscheck's pass 2 evaluates (see the index maps in `kernels.vsconv`).

def vsmm_x_index_map():
    """Activation K-tile gather: the s-th stored vector of strip j reads
    activation K-tile idx[j, s] (the paper's index system)."""
    def index_map(j, mi, s, idx):
        return (mi, idx[j, s])
    return index_map


def vsmm_w_index_map():
    """The s-th stored weight vector of strip j."""
    def index_map(j, mi, s, idx):
        return (j, s, 0, 0)
    return index_map


def vsmm_out_index_map():
    """Output/residual (row-block, strip) tile."""
    def index_map(j, mi, s, idx):
        return (mi, j)
    return index_map


def vsmm_bias_index_map():
    """Strip j's bias (or int8 dequant scale) tile."""
    def index_map(j, mi, s, idx):
        return (j, 0)
    return index_map


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
    out_dtype: torch.dtype | None = None,
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
    f32.  bf16 ``x`` and ``vs.vals`` are widened to f32: each product is
    exact, the sum f32.  The result is cast to ``out_dtype`` (f32 for
    int8 operands by default, else x's dtype).  It never skips
    (``skip_zero_inputs`` is taken for the kernel's signature).
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
    return y.to(_out_dtype(x, out_dtype))


def _out_dtype(x: torch.Tensor, out_dtype: torch.dtype | None
               ) -> torch.dtype:
    """The reference's default: f32 for int8 operands, else x's dtype."""
    if out_dtype is not None:
        return out_dtype
    return torch.float32 if x.dtype == torch.int8 else x.dtype


def check_operands(named: dict[str, torch.Tensor | None],
                   device: torch.device, *, bf16: bool = False) -> bool:
    """Raise unless every given tensor is a contiguous tensor on ``device``
    of the dtype the CUDA kernels take: int32 ``idx``, float32 for the
    rest, except int8 ``x`` and ``vals`` together with a ``scale`` (the
    int8 entries) and, where the kernel has a bf16 branch (``bf16``:
    vsmm), bf16 ``x`` and ``vals`` together.  Returns True for the int8
    entries."""
    int8 = named["x"].dtype == torch.int8
    half = bf16 and named["x"].dtype == torch.bfloat16
    if int8 and named.get("scale") is None:
        raise ValueError("int8 operands need a dequant scale")
    for name, t in named.items():
        if t is None:
            continue
        want = (torch.int32 if name == "idx"
                else torch.int8 if int8 and name in ("x", "vals")
                else torch.bfloat16 if half and name in ("x", "vals")
                else torch.float32)
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes a contiguous {want} tensor on "
                f"{device}, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    return int8


def entry_name(fn: str, int8: bool, bf16: bool = False) -> str:
    """The extern "C" launch entry of a kernel's int8 branch
    (``<kernel>_int8_launch``), its bf16 one (``<kernel>_bf16_launch``)
    or its f32 one (``fn``)."""
    if int8 or bf16:
        return fn.replace("_launch", "_int8_launch" if int8
                          else "_bf16_launch")
    return fn


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
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """x (M, K) @ vector-sparse W (K, N) -> (M, N), epilogue fused.

    CUDA tensors launch ``csrc/vsmm.cu`` on the current stream (built at
    first use), cut by `vsmm_plan` (bf16: `vsmm_bf16_plan`; two launches
    where it splits the stored steps), through the custom op
    ``repro_torch::vsmm``, and so do meta tensors, whose fake
    implementation launches nothing; CPU tensors run `vsmm_plain`.
    ``bias``/``scale`` are (N,),
    ``residual`` (M, N).  Any M works: the kernel masks the ragged tail.
    int8 ``x`` and ``vs.vals`` with a ``scale`` launch the int8 branch
    (counted on ``int8_launches`` too), bf16 ones the bf16 branch (on
    ``bf16_launches``).  ``skip_zero_inputs=False`` turns the input-side
    skip off.  The output is ``out_dtype`` (f32 or bf16; by default f32
    for int8 operands, else x's dtype).
    """
    if x.device.type == "cpu":
        return vsmm_plain(x, vs, bias=bias, residual=residual, scale=scale,
                          fuse_relu=fuse_relu, out_dtype=out_dtype)
    if not card_path(x):
        raise ValueError(f"vsmm_kernel runs on cuda or cpu, not {x.device}")
    k = x.shape[1]
    nb, _, vk, vn = vs.vals.shape
    if vs.shape != (k, nb * vn) or k % vk:
        raise ValueError(f"x {tuple(x.shape)} does not match W {vs.shape} "
                         f"with tiles ({vk}, {vn})")
    return _vsmm_op(x, vs.vals, vs.idx, bias, residual, scale, fuse_relu,
                    skip_zero_inputs, out_dtype)


def _check_call(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                bias: torch.Tensor | None, residual: torch.Tensor | None,
                scale: torch.Tensor | None, out_dtype: torch.dtype | None
                ) -> tuple[bool, bool, torch.dtype]:
    """Raise unless the kernel takes this call; (int8, bf16, out dtype)."""
    m = x.shape[0]
    nb, _, _, vn = vals.shape
    if vn > MAX_VN:
        raise ValueError(f"vsmm_kernel takes vn <= {MAX_VN}, got {vn}")
    check_epilogue(bias=bias, scale=scale, residual=residual, cout=nb * vn,
                   out_shape=(m, nb * vn))
    int8 = check_operands({"x": x, "vals": vals, "idx": idx,
                           "bias": bias, "scale": scale,
                           "residual": residual}, x.device, bf16=True)
    dt = _out_dtype(x, out_dtype)
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vsmm_kernel writes f32 or bf16, not {dt}")
    return int8, x.dtype == torch.bfloat16, dt


def _plan(x: torch.Tensor, vals: torch.Tensor, int8: bool, bf16: bool
          ) -> tuple[int, int, tuple[int, ...], torch.dtype]:
    """(rows, splits, workspace shape, workspace dtype): each chunk's
    partial, f32 or int8's (T_c, A_c) pair; no workspace unsplit."""
    m = x.shape[0]
    nb, s_steps, vk, vn = vals.shape
    rows, splits = (vsmm_bf16_plan(m, nb, s_steps, vk, vn) if bf16
                    else vsmm_plan(m, nb, s_steps, vk, vn, int8))
    work = (((splits, m, nb * vn, 2) if int8 else (splits, m, nb * vn))
            if splits > 1 else ())
    return rows, splits, work, torch.int32 if int8 else torch.float32


@torch.library.custom_op("repro_torch::vsmm", mutates_args=(),
                         device_types="cuda")
def _vsmm_op(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
             bias: torch.Tensor | None, residual: torch.Tensor | None,
             scale: torch.Tensor | None, fuse_relu: bool,
             skip_zero_inputs: bool,
             out_dtype: torch.dtype | None) -> torch.Tensor:
    """One kernel call (one or two launches; none for M = 0)."""
    int8, bf16, dt = _check_call(x, vals, idx, bias, residual, scale,
                                 out_dtype)
    m, k = x.shape
    nb, s_steps, vk, vn = vals.shape
    out = torch.empty((m, nb * vn), dtype=dt, device=x.device)
    if m == 0:
        return out
    rows, splits, shape, wdt = _plan(x, vals, int8, bf16)
    work = torch.empty(shape, dtype=wdt, device=x.device) if shape else None
    launch("vsmm", entry_name("vsmm_launch", int8, bf16),
           (x, vals, idx, scale, bias, residual, out, work),
           (m, k, nb, s_steps, vk, vn, int(fuse_relu),
            int(skip_zero_inputs), splits, rows,
            int(dt == torch.bfloat16)), x.device)
    vsmm_kernel.launches += 1
    vsmm_kernel.int8_launches += int(int8)
    vsmm_kernel.bf16_launches += int(bf16)
    return out


@_vsmm_op.register_kernel("cpu")
def _(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
      bias: torch.Tensor | None, residual: torch.Tensor | None,
      scale: torch.Tensor | None, fuse_relu: bool, skip_zero_inputs: bool,
      out_dtype: torch.dtype | None) -> torch.Tensor:
    vs = VectorSparse(vals=vals, idx=idx,
                      shape=(x.shape[1], vals.shape[0] * vals.shape[3]))
    return vsmm_plain(x, vs, bias=bias, residual=residual, scale=scale,
                      fuse_relu=fuse_relu, out_dtype=out_dtype)


@_vsmm_op.register_fake
def _(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
      bias: torch.Tensor | None, residual: torch.Tensor | None,
      scale: torch.Tensor | None, fuse_relu: bool, skip_zero_inputs: bool,
      out_dtype: torch.dtype | None) -> torch.Tensor:
    _, _, dt = _check_call(x, vals, idx, bias, residual, scale, out_dtype)
    return x.new_empty((x.shape[0], vals.shape[0] * vals.shape[3]),
                       dtype=dt)


def _op_cost(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
             bias: torch.Tensor | None, residual: torch.Tensor | None,
             scale: torch.Tensor | None, fuse_relu: bool,
             skip_zero_inputs: bool,
             out_dtype: torch.dtype | None) -> tuple[int, int, int]:
    m = x.shape[0]
    if m == 0:
        return 0, 0, 0
    nb, s_steps, vk, vn = vals.shape
    int8 = x.dtype == torch.int8
    c = vsmm_kernel_cost(
        m=m, nb=nb, s_steps=s_steps, vk=vk, vn=vn,
        in_itemsize=x.element_size(), w_itemsize=vals.element_size(),
        out_itemsize=_out_dtype(x, out_dtype).itemsize,
        residual_bytes=0 if residual is None
        else residual.numel() * residual.element_size())
    _, _, shape, wdt = _plan(x, vals, int8, x.dtype == torch.bfloat16)
    scratch = math.prod(shape) * wdt.itemsize if shape else 0
    return c["flops"], c["bytes_accessed"], scratch


register_kernel_cost(_vsmm_op._opoverload, "vsmm", _op_cost)
vsmm_kernel.launches = 0  # type: ignore[attr-defined]
vsmm_kernel.int8_launches = 0  # type: ignore[attr-defined]
vsmm_kernel.bf16_launches = 0  # type: ignore[attr-defined]
