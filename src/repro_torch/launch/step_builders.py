"""The steps of an (arch, shape) cell, their inputs and shardings, and the
useful-work FLOPs.

The port of `repro/launch/step_builders.py`: `make_optimizer`,
`param_structs` (`:41`), the shardings (`_shard`, `tree_shardings`,
`param_shardings`, `opt_state_axes`, `:47-98`; the batch's by
`shard_batch`), `build_train` (`:115`), `build_prefill` (`:180`),
`build_decode` (`:219`), `build` (`:248`) and `model_flops`.  Where the reference
builds ShapeDtypeStructs, the port builds empty tensors on a device: on
``meta`` they allocate nothing, and the dry run (`launch.dryrun`) counts
the step on them (`utils.cost`).  A sharding is a
`parallel.sharding.NamedSharding` (a mesh and a spec); `build_train`
with a mesh ``ctx`` takes params, optimizer state and batch as DTensors
laid out by them, under the context's rules (`launch.train.TrainLoop`
with ``mesh=``).  `build` with a mesh ``ctx`` builds every kind of step
under it, its arguments each rank's shards (the dry run of the
production mesh counts one rank's step, `launch.dryrun`); `build_prefill`
and `build_decode` lay the caches out by `transformer.cache_axes`, as
the reference's out- and in-shardings do (`:180-246`).  The server calls
`models.transformer.prefill` / `decode_step` itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import P, axes_tree
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          clip_by_global_norm_, pieces)
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.parallel import sharding as shd
from repro_torch.utils.tree import leaves, tree_map, tree_unflatten

__all__ = ["Step", "make_optimizer", "param_structs", "tree_shardings",
           "param_shardings", "opt_state_axes", "init_opt_state",
           "shard_batch", "build_train", "build_prefill", "build_decode",
           "build", "model_flops", "TRAIN_STEP"]

TRAIN_STEP = 200  # the step a built train step runs: the schedule's peak lr


@dataclasses.dataclass
class Step:
    """A built step: ``fn(*args)`` runs it (the reference's
    `StepArtifacts`, without shardings or donation)."""

    fn: Callable[..., Any]
    args: tuple


def make_optimizer(cfg) -> Optimizer:
    if cfg.optimizer == "adafactor":
        return adafactor()
    return adamw()


def param_structs(cfg, device: str | torch.device = "meta") -> Any:
    """The param tree of ``cfg`` (`transformer.lm_schema`) as empty
    tensors on ``device``, in each leaf's dtype: no draw, and on meta no
    memory."""
    return tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype or cfg.dtype,
                              device=device),
        tfm.lm_schema(cfg), is_leaf=lambda n: isinstance(n, P))


# ---------------------------------------------------------------------------
# shardings (reference :47-98)
# ---------------------------------------------------------------------------


def _shard(axes: tuple, shape: tuple, ctx: shd.MeshContext
           ) -> shd.NamedSharding:
    return shd.NamedSharding(ctx.mesh, shd.spec_for(
        axes, mesh=ctx.mesh, rules=ctx.rules, shape=tuple(shape)))


def _is_axes(t: Any) -> bool:
    return isinstance(t, tuple)


def tree_shardings(axes_tr: Any, struct_tr: Any, ctx: shd.MeshContext
                   ) -> Any:
    """A tree of logical-axes tuples and the matching tree of tensors ->
    the tree of their `NamedSharding`s."""
    return tree_map(lambda a, s: _shard(a, s.shape, ctx), axes_tr,
                    struct_tr, is_leaf=_is_axes)


def param_shardings(cfg, ctx: shd.MeshContext, schema: Any = None
                    ) -> tuple[Any, Any]:
    """(the param tree's shardings, its `param_structs` on meta)."""
    schema = schema or tfm.lm_schema(cfg)
    structs = param_structs(cfg)
    return tree_shardings(axes_tree(schema), structs, ctx), structs


def opt_state_axes(cfg, schema: Any) -> dict:
    """The logical-axes tree of the optimizer state: AdamW's moments laid
    out as their params, an optimizer's with ``state_axes`` (Adafactor's,
    `optim.adamw8bit`'s) by them; the count replicated."""
    p_axes = axes_tree(schema)
    opt = make_optimizer(cfg)
    if opt.state_axes is not None:
        return {"moments": tree_map(lambda p: opt.state_axes(p.axes,
                                                             p.shape),
                                    schema,
                                    is_leaf=lambda n: isinstance(n, P)),
                "count": ()}
    return {"m": p_axes, "v": p_axes, "count": ()}


def init_opt_state(cfg, params: Any, ctx: shd.MeshContext | None = None
                   ) -> Any:
    """A fresh optimizer state for ``params``; under a mesh ``ctx`` each
    leaf a DTensor of zeros laid out by `opt_state_axes` (each rank makes
    its own shard)."""
    opt = make_optimizer(cfg)
    if ctx is None:
        return opt.init(params)
    structs = opt.init(tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        params))
    device = leaves(params)[0].device
    axes = opt_state_axes(cfg, tfm.lm_schema(cfg))
    return tree_map(
        lambda a, s: shd.zeros(tuple(s.shape), a, dtype=s.dtype,
                               device=device, ctx=ctx),
        axes, structs, is_leaf=_is_axes)


def _batch_axes(cfg) -> dict:
    if cfg.embed_inputs:
        return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    return {"embeds": ("batch", "seq", None), "labels": ("batch", "seq")}


def shard_batch(cfg, batch: dict, ctx: shd.MeshContext) -> dict:
    """The global batch (the same on every rank) as DTensors on
    ``("batch", "seq")``: each rank keeps its rows."""
    axes = _batch_axes(cfg)
    return {k: shd.distribute(v, axes[k], ctx=ctx) for k, v in batch.items()}


def _inputs(cfg, b: int, t: int, device: str | torch.device) -> dict:
    """A batch's model inputs, empty: ``tokens`` (b, t) int32, or
    ``embeds`` (b, t, d_model) in the config's dtype."""
    if cfg.embed_inputs:
        return {"tokens": torch.empty((b, t), dtype=torch.int32,
                                      device=device)}
    return {"embeds": torch.empty((b, t, cfg.d_model), dtype=cfg.dtype,
                                  device=device)}


def _in_mesh(fn: Callable[..., Any], ctx: shd.MeshContext | None
             ) -> Callable[..., Any]:
    """``fn`` run under the mesh ``ctx`` (itself without one)."""
    if ctx is None:
        return fn

    def run(*args: Any) -> Any:
        with shd.use_mesh(ctx.mesh, ctx.rules):
            return fn(*args)
    return run


def _sharded_params(cfg, device, params: Any, ctx: shd.MeshContext | None
                    ) -> Any:
    """``params`` (default `param_structs` on ``device``), under a mesh
    ``ctx`` laid out by the schema (`transformer.shard_params`)."""
    params = param_structs(cfg, device) if params is None else params
    if ctx is None:
        return params
    with shd.use_mesh(ctx.mesh, ctx.rules):
        return tfm.shard_params(params, cfg)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _grads_of(params: Any, batch: dict, cfg
              ) -> tuple[torch.Tensor, dict, list]:
    """(loss, metrics, grads): the grads a list in `leaves` order, each in
    its parameter's dtype and contiguous (zeros for a leaf the loss does
    not reach).  Under a mesh each grad is a DTensor in its parameter's
    placements (a partial sum reduced to them), and loss and metrics are
    this rank's copies of the replicated values."""
    flat = leaves(params)
    req = [p.detach().requires_grad_() for p in flat]
    loss, metrics = tfm.loss_fn(tree_unflatten(params, req), batch, cfg)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    out = []
    for p, g in zip(flat, grads):
        if g is None:
            g = torch.zeros_like(p)
        elif isinstance(p, DTensor):
            if tuple(g.placements) != tuple(p.placements):
                g = g.redistribute(p.device_mesh, p.placements)
            g = DTensor.from_local(g.to_local().contiguous(), p.device_mesh,
                                   p.placements, run_check=False,
                                   shape=p.shape, stride=p.stride())
        else:
            g = g.contiguous()
        out.append(g)
    return (_local(loss).detach(),
            {k: _local(v).detach() for k, v in metrics.items()}, out)


def _microbatch(batch: dict, i: int, n: int, cfg,
                ctx: shd.MeshContext | None) -> dict:
    """Rows [i*n, (i+1)*n) of the global batch, laid out as a batch."""
    if ctx is None:
        return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
    return shard_batch(cfg, {k: v.full_tensor()[i * n:(i + 1) * n]
                             for k, v in batch.items()}, ctx)


def build_train(cfg, shape, ctx: shd.MeshContext | None = None, *,
                grad_clip: float = 1.0
                ) -> Callable[..., tuple[Any, Any, dict]]:
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: the reference's step.

    The loss's gradient (`transformer.loss_fn`); with ``cfg.microbatches``
    > 1 the batch split on axis 0 into that many microbatches, each one's
    grads (in the parameter's dtype) added into an accumulator at
    ``cfg.grad_accum_dtype`` as ``(g.float() / mb).to(acc_dtype)``, and
    ``loss`` / ``ce`` / ``aux`` averaged over them; the grads clipped to a
    global norm of ``grad_clip``; the optimizer's update at
    ``warmup_cosine(3e-4, 200, 10_000)(step)``, added to each parameter
    in its dtype.  Clip, optimizer state and parameters are updated in
    place (`optim.optimizers`: the reference's values), so ``params`` and
    ``opt_state`` come back as the same trees.  Metrics:
    ``loss``, ``ce``, ``aux`` and ``grad_norm``, 0-d f32 tensors.

    With a mesh ``ctx`` (`parallel.sharding.MeshContext`) the step runs
    under it: params and state are DTensors laid out by
    `param_shardings` and `opt_state_axes`, the batch by `shard_batch`
    (a microbatch is rows of the *global* batch, laid out again), the
    grads come in their params' placements, and accumulation, clip and
    update run on the local shards.  The metrics are this rank's copies
    of replicated values.
    """
    opt = make_optimizer(cfg)
    lr_fn = warmup_cosine(3e-4, 200, 10_000)
    mb = cfg.microbatches
    if shape.global_batch % max(mb, 1):
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{mb} microbatches")
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)

    def context():
        if ctx is None:
            return contextlib.nullcontext()
        return shd.use_mesh(ctx.mesh, ctx.rules)

    def train_step(params: Any, opt_state: Any, batch: dict,
                   step: int | torch.Tensor) -> tuple[Any, Any, dict]:
        with context():
            if mb <= 1:
                loss, metrics, grads = _grads_of(params, batch, cfg)
            else:
                n = next(iter(batch.values())).shape[0] // mb
                grads = [torch.zeros_like(p, dtype=acc_dtype)
                         for p in leaves(params)]
                z = torch.zeros((), dtype=torch.float32,
                                device=_local(grads[0]).device)
                loss, ce, aux = z, z, z
                for i in range(mb):
                    l_i, m_i, g_i = _grads_of(
                        params, _microbatch(batch, i, n, cfg, ctx), cfg)
                    with torch.no_grad():
                        for acc, g in zip(grads, g_i):
                            for a, b in pieces(_local(acc), _local(g)):
                                a.add_((b.float() / mb).to(a.dtype))
                    del g_i
                    loss = loss + l_i / mb
                    ce = ce + m_i["ce"] / mb
                    aux = aux + m_i["aux"] / mb
                metrics = {"ce": ce, "aux": aux}
            gnorm = clip_by_global_norm_(grads, grad_clip)
            opt.update_(tree_unflatten(params, grads), opt_state, params,
                        lr_fn(step))
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def build_prefill(cfg, shape, device: str | torch.device = "meta",
                  params: Any = None, ctx: shd.MeshContext | None = None
                  ) -> Step:
    """``prefill(params, batch)`` of ``shape.global_batch`` prompts of
    ``shape.seq_len`` tokens into fresh caches of that capacity -> (last
    logits, caches); an encoder-only config gives per-position logits
    and no cache, as the reference's does (`:194-217`).  ``params``
    (default `param_structs`) in the served form (`prepare_params`).
    Under a mesh ``ctx`` the params are laid out by the schema, the
    batch on ``("batch", "seq")``, and the step runs under the mesh (its
    fresh caches laid out by `transformer.cache_axes`)."""
    b, t = shape.global_batch, shape.seq_len
    params = _sharded_params(cfg, device, params, ctx)
    batch = _inputs(cfg, b, t, device)
    with (shd.use_mesh(ctx.mesh, ctx.rules) if ctx is not None
          else contextlib.nullcontext()):
        params = tfm.prepare_params(params, cfg)
        if ctx is not None:
            batch = {k: shd.distribute(v, _batch_axes(cfg)[k], ctx=ctx)
                     for k, v in batch.items()}

    def prefill(params: Any, batch: dict) -> Any:
        if cfg.encoder_only:
            return tfm.lm_apply(params, batch, cfg)
        return tfm.prefill(params, batch, cfg, capacity=t)

    return Step(_in_mesh(prefill, ctx), (params, batch))


def build_decode(cfg, shape, device: str | torch.device = "meta",
                 params: Any = None, ctx: shd.MeshContext | None = None
                 ) -> Step:
    """``decode_step(params, caches, tokens, pos)``: one token for each of
    ``shape.global_batch`` sequences against caches of capacity
    ``shape.seq_len``, at its last position (``pos`` a 0-d int64 tensor,
    as the server's graphs take it).  ``params`` (default
    `param_structs`) in the served form (`prepare_params`).  Under a mesh
    ``ctx`` the params are laid out by the schema, the caches by
    `transformer.cache_axes`, the tokens on ``("batch", None)``, ``pos``
    replicated, and the step runs under the mesh."""
    b, t = shape.global_batch, shape.seq_len
    params = _sharded_params(cfg, device, params, ctx)
    tokens = _inputs(cfg, b, 1, device)
    tokens = tokens.get("tokens", tokens.get("embeds"))
    pos = torch.full((), t - 1, dtype=torch.int64, device=device)
    with (shd.use_mesh(ctx.mesh, ctx.rules) if ctx is not None
          else contextlib.nullcontext()):
        params = tfm.prepare_params(params, cfg)
        caches = tfm.init_cache(cfg, b, t, torch.device(device))
        if ctx is not None:
            tokens = shd.distribute(tokens, ("batch",) + (None,) * (
                tokens.ndim - 1), ctx=ctx)

    def decode(params: Any, caches: list, tokens: torch.Tensor,
               pos: torch.Tensor) -> Any:
        return tfm.decode_step(params, caches, tokens, pos, cfg)

    return Step(_in_mesh(decode, ctx), (params, caches, tokens, pos))


def build(cfg, shape, device: str | torch.device = "meta",
          params: Any = None, ctx: shd.MeshContext | None = None) -> Step:
    """The cell's step by ``shape.kind``: ``train`` is `build_train`'s
    step on (params, a fresh optimizer state, a batch of ``tokens`` or
    ``embeds`` and int32 ``labels``, `TRAIN_STEP`).  Under a mesh
    ``ctx`` each argument is this rank's shards: the params laid out by
    `param_shardings`, the optimizer state by `opt_state_axes`
    (`init_opt_state`), the batch by `shard_batch`."""
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, device, params, ctx)
    if shape.kind == "decode":
        return build_decode(cfg, shape, device, params, ctx)
    params = _sharded_params(cfg, device, params, ctx)
    b, t = shape.global_batch, shape.seq_len
    batch = dict(_inputs(cfg, b, t, device),
                 labels=torch.empty((b, t), dtype=torch.int32, device=device))
    if ctx is None:
        state = make_optimizer(cfg).init(params)
    else:
        state = init_opt_state(cfg, params, ctx)
        batch = shard_batch(cfg, batch, ctx)
    return Step(build_train(cfg, shape, ctx), (params, state, batch,
                                               TRAIN_STEP))


def model_flops(cfg, shape) -> float:
    """6*N_active*D for training, 2*N_active*D for inference (global;
    attention-score FLOPs excluded by convention)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
