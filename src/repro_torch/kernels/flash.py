"""flash_fwd — attention forward: CUDA kernel, wrapper, plain version.

The kernel (``csrc/flash_fwd.cu``) replaces the JAX package's Pallas kernel
`repro/kernels/flash.py::flash_fwd_pallas`: q (BH, Tq, hd), k/v (BH, Tk,
hd) -> softmax(mask(q k^T * hd^-0.5)) v in q's dtype, with causal and
sliding-window masks and query positions offset by ``q_offset``.  Heads are
flattened into BH; grouped-query callers repeat K/V first.  It has two
bodies (`kernel_body`): bf16 inputs run on the tensor cores (``mma.sync``),
f32 inputs on the CUDA cores (f32 FMAs keep the 1e-5 f32 parity).

`flash_fwd_kernel` is the wrapper: it launches the kernel for CUDA tensors
and runs `flash_fwd_plain` for CPU tensors, and nothing else — a CUDA
tensor that the kernel does not take raises, it never falls back.
``flash_fwd_kernel.launches`` counts kernel launches.  The kernel is the
custom op ``repro_torch::flash_fwd`` (`torch.library`), so the dispatcher
sees each launch as one op: its CUDA implementation launches the kernel,
its CPU one is `flash_fwd_plain`, and its fake (meta) one states the
output's shape and dtype, so that the dry run counts it on meta
(`utils.cost`, with `flash_kernel_cost`).

Training: the kernel's output has no ``grad_fn``, so a loss through it
would give q, k and v no gradient.  `flash_fwd_trainable` is the kernel
under autograd (`FlashFwd`): its forward is `flash_fwd_kernel`, its
backward `flash_bwd_plain`, the gradient that the reference's XLA derives
for its jnp flash (it has no Pallas backward), in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import card_path
from repro_torch.kernels._build import launch
from repro_torch.utils.cost import register_kernel_cost

__all__ = ["flash_fwd_kernel", "flash_fwd_plain", "flash_bwd_plain",
           "flash_fwd_trainable", "FlashFwd", "kernel_body", "chunk_size",
           "query_tile", "flash_kernel_cost", "MAX_HD", "NEG_INF"]

NEG_INF = -1e30
MAX_HD = 256  # the f32 body's ceil(hd / 32) <= 8 slots; the bf16 body's
              # hd rounded up to 16, one instantiation per multiple


def kernel_body(dtype: torch.dtype) -> str:
    """The body of ``csrc/flash_fwd.cu`` that a launch on ``dtype`` runs:
    "mma" (bf16, tensor cores) or "simt" (f32, CUDA cores)."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def query_tile(dtype: torch.dtype, hd: int) -> int:
    """Query rows a block of ``csrc/flash_fwd.cu`` takes: the bf16 body
    16 a warp, 8 warps up to hd 128 (rounded up to 16) and 4 above; the
    f32 body 64."""
    if dtype != torch.bfloat16:
        return 64
    return 16 * (8 if -(-hd // 16) * 16 <= 128 else 4)


def flash_kernel_cost(*, bh: int, tq: int, tk: int, hd: int, causal: bool,
                      itemsize: int, block_q: int, q_offset: int = 0
                      ) -> dict[str, int]:
    """The reference's ``pl.CostEstimate`` of the TPU kernel
    (`repro/kernels/flash.py:135-142`): 4 BH Tq Tk hd FLOPs, halved when
    causal; q and the output once, K and V once per query tile
    (``block_q`` rows: the CUDA kernel's, `query_tile`).  Causal, the
    keys a query sees are taken as ``q_offset`` + Tq / 2 on average
    (capped at Tk), which is the reference's half where Tq = Tk at
    offset 0: a sequence-parallel rank's block at ``q_offset`` (`sp`
    attention under a mesh) sees more keys the later its block."""
    nq = -(-tq // block_q)
    keys = min(tk, q_offset + tq / 2) if causal else tk
    return {"flops": int(4 * bh * tq * keys * hd),
            "bytes_accessed": (2 * bh * tq * hd + nq * 2 * bh * tk * hd)
            * itemsize}


def chunk_size(t: int, pref: int) -> int:
    """The largest divisor of ``t`` that is at most ``pref`` (the
    reference's `_chunk_sizes`)."""
    b = min(pref, t)
    while t % b:
        b -= 1
    return b


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the TPU kernel's chain.

    Query blocks of ``chunk_size(Tq, 256)`` rows, kv blocks of
    ``chunk_size(Tk, 512)`` keys (the blocks `_flash_pallas` picks); a kv
    block that no query of the block can see is skipped (the TPU's
    ``live`` test).  Masked scores are -1e30 and the running max starts at
    -1e30; p is rounded to v's dtype before the PV product; the output is
    acc / max(l, 1e-30) in q's dtype.  Runs on any device.
    """
    bh, tq, hd = q.shape
    tk = k.shape[1]
    scale = hd ** -0.5
    bq, bk = chunk_size(tq, 256), chunk_size(tk, 512)
    out = torch.empty_like(q)
    for q0 in range(0, tq, bq):
        qpos0 = q_offset + q0
        qf = q[:, q0:q0 + bq].float()
        m = torch.full((bh, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((bh, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, bq, hd), dtype=torch.float32, device=q.device)
        for k0 in range(0, tk, bk):
            if causal and qpos0 + bq - 1 < k0:
                continue
            if window is not None and not qpos0 < k0 + bk + window - 1:
                continue
            s = torch.einsum("bqd,bkd->bqk", qf,
                             k[:, k0:k0 + bk].float()) * scale
            mask = _mask(qpos0, bq, k0, bk, causal, window, q.device)
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            m = m_new
            pv = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(),
                              v[:, k0:k0 + bk].float())
            acc = acc * corr[..., None] + pv
        denom = torch.clamp_min(l, 1e-30)
        out[:, q0:q0 + bq] = (acc / denom[..., None]).to(q.dtype)
    return out


def _mask(qpos0: int, bq: int, k0: int, bk: int, causal: bool,
          window: int | None, device: torch.device) -> torch.Tensor | None:
    """(bq, bk) bool: which keys at positions k0 + [0, bk) the queries at
    positions qpos0 + [0, bq) see; None where they see every key."""
    if not causal and window is None:
        return None
    qpos = qpos0 + torch.arange(bq, device=device)
    kpos = k0 + torch.arange(bk, device=device)
    mask = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, dout: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of the attention forward: (dq, dk, dv) from the
    forward's inputs, its output ``out`` and the output's gradient
    ``dout``, all (BH, T, hd).

    Per query block of ``chunk_size(Tq, 256)`` rows it recomputes the
    masked scores (-1e30 where masked) and the row softmax P in f32, then
    dV += P^T dO, dP = dO V^T, D = rowsum(dO * O), dS = P (dP - D),
    dQ = dS K hd^-0.5, dK += dS^T Q hd^-0.5; sums in f32 and returns the
    inputs' dtypes.  The bf16 forward's rounding of p before the PV
    product is taken as the identity, as the reference's derivative of a
    ``convert`` is.  Runs on any device.
    """
    bh, tq, hd = q.shape
    tk = k.shape[1]
    scale = hd ** -0.5
    bq = chunk_size(tq, 256)
    kf, vf = k.float(), v.float()
    dq = torch.empty((bh, tq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((bh, tk, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, tq, bq):
        qf = q[:, q0:q0 + bq].float()
        s = torch.bmm(qf, kf.transpose(1, 2)) * scale
        mask = _mask(q_offset + q0, bq, 0, tk, causal, window, q.device)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        do = dout[:, q0:q0 + bq].float()
        dv += torch.bmm(p.transpose(1, 2), do)
        dp = torch.bmm(do, vf.transpose(1, 2))
        d = (do * out[:, q0:q0 + bq].float()).sum(dim=-1, keepdim=True)
        ds = p * (dp - d)
        dq[:, q0:q0 + bq] = torch.bmm(ds, kf) * scale
        dk += torch.bmm(ds.transpose(1, 2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashFwd(torch.autograd.Function):
    """`flash_fwd_kernel` under autograd: the forward launches the kernel
    (on the CPU its plain version) and saves q, k, v and the output; the
    backward is `flash_bwd_plain`."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int | None,
                q_offset: int) -> torch.Tensor:
        out = flash_fwd_kernel(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, out = ctx.saved_tensors
        causal, window, q_offset = ctx.args
        dq, dk, dv = flash_bwd_plain(q, k, v, out, dout, causal=causal,
                                     window=window, q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_fwd_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """`flash_fwd_kernel` with a gradient (`FlashFwd`): the training
    forward's attention on the card."""
    return FlashFwd.apply(q, k, v, causal, window, q_offset)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, q_offset: int) -> None:
    """Raise unless the kernel takes these operands."""
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (BH, Tq, hd) and "
                         f"two (BH, Tk, hd)")
    hd = q.shape[2]
    if hd % 4 or not 4 <= hd <= MAX_HD:
        raise ValueError(f"flash_fwd_kernel takes hd a multiple of 4 up to "
                         f"{MAX_HD}, got {hd}")
    if k.shape[1] < 1:
        raise ValueError("flash_fwd_kernel needs at least one key")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or \
                t.dtype not in (torch.float32, torch.bfloat16) or \
                not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes contiguous float32 or bfloat16 "
                f"tensors of one dtype on {q.device}, got {t.dtype} on "
                f"{t.device} (contiguous={t.is_contiguous()}, q is "
                f"{q.dtype})")


def flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int | None = None,
                     q_offset: int = 0) -> torch.Tensor:
    """q (BH, Tq, hd), k/v (BH, Tk, hd) -> (BH, Tq, hd) in q's dtype.

    CUDA tensors launch ``csrc/flash_fwd.cu`` on the current stream (built
    at first use) through the custom op ``repro_torch::flash_fwd``, and
    so do meta tensors, whose fake implementation launches nothing; CPU
    tensors run `flash_fwd_plain`.  Any Tq and Tk;
    ``window`` None or >= 1; ``q_offset`` >= 0; any alignment of the
    inputs' storage.  In bf16 the kernel steps its online softmax over
    tiles of 64 keys (32 in f32), so it rounds p at another running max
    than the plain version (blocks of up to 512 keys): the two agree within
    a bf16 ulp here and there.
    """
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if not card_path(q):
        raise ValueError(f"flash_fwd_kernel runs on cuda or cpu, not "
                         f"{q.device}")
    return _flash_fwd_op(q, k, v, causal, window, q_offset)


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int | None,
                  q_offset: int) -> torch.Tensor:
    """One launch of the kernel (none for an empty output)."""
    _check(q, k, v, window, q_offset)
    bh, tq, hd = q.shape
    out = torch.empty_like(q)
    if bh == 0 or tq == 0:
        return out
    launch("flash_fwd", "flash_fwd_launch", (q, k, v, out),
           (bh, tq, k.shape[1], hd, int(causal),
            -1 if window is None else window, q_offset,
            int(q.dtype == torch.bfloat16)), q.device)
    flash_fwd_kernel.launches += 1
    return out


@_flash_fwd_op.register_kernel("cpu")
def _(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
      window: int | None, q_offset: int) -> torch.Tensor:
    return flash_fwd_plain(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


@_flash_fwd_op.register_fake
def _(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
      window: int | None, q_offset: int) -> torch.Tensor:
    _check(q, k, v, window, q_offset)
    return torch.empty_like(q)


def _op_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int | None,
             q_offset: int) -> tuple[int, int, int]:
    bh, tq, hd = q.shape
    if bh == 0 or tq == 0:
        return 0, 0, 0
    c = flash_kernel_cost(bh=bh, tq=tq, tk=k.shape[1], hd=hd, causal=causal,
                          itemsize=q.element_size(),
                          block_q=query_tile(q.dtype, hd), q_offset=q_offset)
    return c["flops"], c["bytes_accessed"], 0


register_kernel_cost(_flash_fwd_op._opoverload, "flash_fwd", _op_cost)
flash_fwd_kernel.launches = 0  # type: ignore[attr-defined]
