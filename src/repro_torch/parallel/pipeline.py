"""Pipeline parallelism over the pod dim (GPipe schedule).

The port of `repro/parallel/pipeline.py`, on `torch.distributed`.  At 2+
pods the cross-pod hop is the slowest link; instead of extending data
parallelism across pods (a gradient all-reduce of O(params) a step),
the pod dim can act as a pipeline: each pod owns a contiguous block of
layers, microbatches stream through, and the only cross-pod traffic is
one activation a microbatch a direction, O(B*T*D).

`pipeline_apply` runs a GPipe forward over the ``pod`` dim of a
`DeviceMesh`: stage s holds slice s of the stacked stage params (a
DTensor sharded on its leading dim over ``pod``), microbatches enter at
stage 0, activations hop stage -> stage + 1 (`ppermute`: a batched
isend / irecv on the pod group, an autograd op whose backward is the
reverse permute), and the last stage's outputs are summed to every pod
(a masked ``psum``, with the gradient convention of
`parallel.sharding`).  The whole schedule is differentiable: autograd
through it is the standard GPipe backward, bubble included.  Every
stage runs the same steps and the same permutes in the same order, and
every value is in every rank's graph (the first stage's input is
``where(first, feed, buf)``, the outputs ``where(last, outs, 0)``), so
each backward permute and sum meets its peers.

Bubble fraction = (P-1)/(M+P-1) for P stages and M microbatches: pick
M >= 4*(P-1) to keep it under ~20%.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.parallel import sharding as shd
from repro_torch.utils.tree import tree_map

__all__ = ["gpipe_schedule", "pipeline_apply", "ppermute"]


def _permute(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Rank r of ``group`` sends ``t`` to r + shift and receives from
    r - shift (mod its size); a group of one rank keeps its own (no P2P
    call: NCCL will not send to its own rank)."""
    p = dist.get_world_size(group)
    if p == 1:
        return t.clone()
    r = dist.get_rank(group)
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t,
                      dist.get_global_rank(group, (r + shift) % p), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % p), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, group, shift: int) -> torch.Tensor:
        ctx.group, ctx.shift = group, shift
        return _permute(t, group, shift)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _permute(g, ctx.group, -ctx.shift), None, None


def ppermute(t: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with the pairs ``(i, (i + shift) % p)`` over the
    mesh dim ``axis`` of the active mesh; its gradient is the reverse
    permute."""
    group = shd.current().mesh.get_group(axis)
    if torch.is_grad_enabled() and t.requires_grad:
        return _PPermute.apply(t, group, shift)
    return _permute(t, group, shift)


def gpipe_schedule(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_mb: torch.Tensor, *, axis: str
                   ) -> torch.Tensor:
    """Run by every rank under a mesh (`parallel.sharding.use_mesh`).
    ``stage_params``: this stage's params; ``x_mb`` (M, ...) microbatch
    inputs (read at stage 0).  Returns (M, ...) outputs (the last
    stage's; zeros elsewhere)."""
    p = shd.axis_size(axis)
    sid = shd.axis_index(axis)
    m = x_mb.shape[0]
    first = torch.tensor(sid == 0, device=x_mb.device)
    last = torch.tensor(sid == p - 1, device=x_mb.device)
    buf = torch.zeros_like(x_mb[0])
    outs = []
    for t in range(m + p - 1):
        x_in = torch.where(first, x_mb[min(t, m - 1)], buf)
        y = stage_fn(stage_params, x_in)
        if t >= p - 1:  # retire a finished microbatch (the last stage's)
            outs.append(y)
        if t < m + p - 2:  # the last hop's buffer is never read
            buf = ppermute(y, axis)
    outs = torch.stack(outs).to(x_mb.dtype)
    return torch.where(last, outs, torch.zeros_like(outs))


def _stage_slice(a: DTensor, dim: int) -> torch.Tensor:
    """This stage's slice of a stacked leaf: the local shard of a DTensor
    sharded on dim 0 over the pod dim (mesh dim ``dim``) only."""
    if not isinstance(a, DTensor) or a.placements[dim] != Shard(0) or any(
            not pl.is_replicate() for i, pl in enumerate(a.placements)
            if i != dim):
        raise ValueError(f"stage params must be DTensors sharded on dim 0 "
                         f"over the pod dim only, got "
                         f"{getattr(a, 'placements', type(a).__name__)}")
    return shd.shard_of(a)[0]


def pipeline_apply(mesh: DeviceMesh, stage_fn, all_stage_params: Any,
                   x_mb: DTensor, *, pod_axis: str = "pod") -> DTensor:
    """GPipe over the dim ``pod_axis`` of ``mesh``.

    ``all_stage_params``: a tree whose leaves have a leading stage dim of
    the pod size, DTensors sharded on it over ``pod_axis`` (stage s holds
    slice s; their gradients come back in that layout).  ``x_mb`` (M,
    ...) microbatches, a replicated DTensor.  Returns the (M, ...)
    outputs, a replicated DTensor (the reference's ``out_specs=P()``)."""
    dim = mesh.mesh_dim_names.index(pod_axis)
    with shd.use_mesh(mesh):
        params = tree_map(lambda a: _stage_slice(a, dim), all_stage_params)
        outs = gpipe_schedule(stage_fn, params, shd.shard_of(x_mb),
                              axis=pod_axis)
        outs = shd.all_reduce(outs, pod_axis)
    return shd.wrap(outs, mesh, (Replicate(),) * mesh.ndim,
                    tuple(outs.shape))
