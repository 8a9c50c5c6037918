"""Cross-pod gradient compression: an fp8-block all-reduce with error
feedback.

The port of `repro/parallel/compression.py`, on `torch.distributed`.
At multi-pod scale the ``pod`` dim rides the slowest links, so its leg
of the gradient reduction is the one worth compressing.  Wire format:
per block of ``block`` values, fp8 (``float8_e4m3fn``) codes and an f32
amax scale: about an eighth of the f32 volume.  Error feedback carries
each rank's quantization residual into its next step, so the
compression is unbiased over time (Seide et al. / EF-SGD).

`compressed_psum(x, axis, err)` is the primitive, run by every rank on
its own ``x`` (the reference's body under ``shard_map``): each rank
quantizes ``x + err``, the codes are all-gathered (as their ``uint8``
bits: gloo takes no float8) with the scales, and every rank sums the
dequantized blocks in f32 in rank order (``"pnb,pn->nb"``).
`apply_to_grads` does it for every leaf of a gradient tree.  No training
flag turns it on: the reference's docstring names ``--grad-compression``,
but its CLI has no such flag either.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding as shd
from repro_torch.utils.tree import leaves, tree_map, tree_unflatten

__all__ = ["quantize_fp8_block", "dequantize_fp8_block", "compressed_psum",
           "apply_to_grads", "init_error_state", "FP8", "FP8_MAX", "BLOCK"]

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
BLOCK = 512


def _pad_to(x: torch.Tensor, m: int) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % m
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat, pad


def quantize_fp8_block(x: torch.Tensor, block: int = BLOCK
                       ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """x -> (fp8 codes (Nb, block), f32 scales (Nb,), pad): each block
    divided by its amax / 448 (at least 1e-12) and rounded to fp8.  The
    quotient is a true division on every device: 448 is a 0-d tensor on
    x's device, since CUDA divides by a Python number as a multiply by
    its reciprocal, and 1/448 is not exact in f32."""
    flat, pad = _pad_to(x.float(), block)
    blocks = flat.reshape(-1, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    fp8_max = torch.full((), FP8_MAX, dtype=amax.dtype, device=amax.device)
    scale = torch.clamp_min(amax / fp8_max, 1e-12)
    return (blocks / scale).to(FP8), scale[:, 0], pad


def dequantize_fp8_block(q: torch.Tensor, scale: torch.Tensor, pad: int,
                         shape: tuple) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _group(axis: str):
    """The process group of mesh dim ``axis`` of the active mesh
    (`parallel.sharding.use_mesh`): the reference's axis name."""
    ctx = shd.current()
    if ctx is None:
        raise RuntimeError(f"axis {axis!r} needs an active use_mesh()")
    return ctx.mesh.get_group(axis)


def compressed_psum(x: torch.Tensor, axis: str, err: torch.Tensor,
                    block: int = BLOCK
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum ``x`` over the ranks of ``axis`` with the fp8 wire format and
    error feedback -> (sum in x's dtype, this rank's new error f32).

    Each rank quantizes ``x + err``; the codes (as uint8) and scales are
    all-gathered, and the dequantized blocks summed in f32 in rank
    order; the new error is ``x + err`` less this rank's own dequantized
    blocks."""
    target = x.float() + err
    q, scale, pad = quantize_fp8_block(target, block)
    new_err = target - dequantize_fp8_block(q, scale, pad, tuple(x.shape))
    group = _group(axis)
    p = dist.get_world_size(group)
    codes = q.view(torch.uint8)
    q_all, s_all = [codes], [scale]
    if p > 1:
        q_all = [torch.empty_like(codes) for _ in range(p)]
        s_all = [torch.empty_like(scale) for _ in range(p)]
        dist.all_gather(q_all, codes.contiguous(), group=group)
        dist.all_gather(s_all, scale.contiguous(), group=group)
    total = q_all[0].view(FP8).float() * s_all[0][:, None]
    for qi, si in zip(q_all[1:], s_all[1:]):
        total = total + qi.view(FP8).float() * si[:, None]
    total = total.reshape(-1)
    if pad:
        total = total[:-pad]
    return total.reshape(x.shape).to(x.dtype), new_err


def init_error_state(grads: Any) -> Any:
    """Zeros in f32, one a gradient leaf."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def apply_to_grads(grads: Any, err_state: Any, axis: str,
                   block: int = BLOCK) -> tuple[Any, Any]:
    """`compressed_psum` of every leaf, in leaf order -> (summed grads,
    new error state)."""
    out = [compressed_psum(g, axis, e, block)
           for g, e in zip(leaves(grads), leaves(err_state))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(err_state, [o[1] for o in out]))
