"""The steps of an (arch, shape) cell, their inputs, and the useful-work
FLOPs.

The port of the one-device half of `repro/launch/step_builders.py`:
`make_optimizer`, `param_structs` (`:41`), `build_train` (`:115`),
`build_prefill` (`:180`), `build_decode` (`:219`), `build` (`:248`) and
`model_flops`, without a mesh: the port serves under a mesh
(`parallel.sharding`, `launch.mesh`) but does not train under one yet,
so there are no shardings to build.  Where the reference builds ShapeDtypeStructs,
the port builds empty tensors on a device: on ``meta`` they allocate
nothing, and the dry run (`launch.dryrun`) counts the step on them
(`utils.cost`).  The server calls `models.transformer.prefill` /
`decode_step` itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import P
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          clip_by_global_norm_, pieces)
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.utils.tree import leaves, tree_map, tree_unflatten

__all__ = ["Step", "make_optimizer", "param_structs", "build_train",
           "build_prefill", "build_decode", "build", "model_flops",
           "TRAIN_STEP"]

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


def _inputs(cfg, b: int, t: int, device: str | torch.device) -> dict:
    """A batch's model inputs, empty: ``tokens`` (b, t) int32, or
    ``embeds`` (b, t, d_model) in the config's dtype."""
    if cfg.embed_inputs:
        return {"tokens": torch.empty((b, t), dtype=torch.int32,
                                      device=device)}
    return {"embeds": torch.empty((b, t, cfg.d_model), dtype=cfg.dtype,
                                  device=device)}


def _grads_of(params: Any, batch: dict, cfg
              ) -> tuple[torch.Tensor, dict, list]:
    """(loss, metrics, grads): the grads a list in `leaves` order, each in
    its parameter's dtype and contiguous (zeros for a leaf the loss does
    not reach)."""
    flat = leaves(params)
    req = [p.detach().requires_grad_() for p in flat]
    loss, metrics = tfm.loss_fn(tree_unflatten(params, req), batch, cfg)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.contiguous()
             for p, g in zip(flat, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def build_train(cfg, shape, *, grad_clip: float = 1.0
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
    """
    opt = make_optimizer(cfg)
    lr_fn = warmup_cosine(3e-4, 200, 10_000)
    mb = cfg.microbatches
    if shape.global_batch % max(mb, 1):
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{mb} microbatches")
    acc_dtype = getattr(torch, cfg.grad_accum_dtype)

    def train_step(params: Any, opt_state: Any, batch: dict,
                   step: int | torch.Tensor) -> tuple[Any, Any, dict]:
        if mb <= 1:
            loss, metrics, grads = _grads_of(params, batch, cfg)
        else:
            n = next(iter(batch.values())).shape[0] // mb
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in leaves(params)]
            z = torch.zeros((), dtype=torch.float32,
                            device=grads[0].device)
            loss, ce, aux = z, z, z
            for i in range(mb):
                b_i = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_i, m_i, g_i = _grads_of(params, b_i, cfg)
                with torch.no_grad():
                    for acc, g in zip(grads, g_i):
                        for a, b in pieces(acc, g):
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
                  params: Any = None) -> Step:
    """``prefill(params, batch)`` of ``shape.global_batch`` prompts of
    ``shape.seq_len`` tokens into fresh caches of that capacity -> (last
    logits, caches); an encoder-only config gives per-position logits
    and no cache, as the reference's does (`:194-217`).  ``params``
    (default `param_structs`) in the served form (`prepare_params`)."""
    b, t = shape.global_batch, shape.seq_len
    params = tfm.prepare_params(
        param_structs(cfg, device) if params is None else params, cfg)

    def prefill(params: Any, batch: dict) -> Any:
        if cfg.encoder_only:
            return tfm.lm_apply(params, batch, cfg)
        return tfm.prefill(params, batch, cfg, capacity=t)

    return Step(prefill, (params, _inputs(cfg, b, t, device)))


def build_decode(cfg, shape, device: str | torch.device = "meta",
                 params: Any = None) -> Step:
    """``decode_step(params, caches, tokens, pos)``: one token for each of
    ``shape.global_batch`` sequences against caches of capacity
    ``shape.seq_len``, at its last position (``pos`` a 0-d int64 tensor,
    as the server's graphs take it).  ``params`` (default
    `param_structs`) in the served form (`prepare_params`)."""
    b, t = shape.global_batch, shape.seq_len
    params = tfm.prepare_params(
        param_structs(cfg, device) if params is None else params, cfg)
    caches = tfm.init_cache(cfg, b, t, torch.device(device))
    tokens = _inputs(cfg, b, 1, device)
    tokens = tokens.get("tokens", tokens.get("embeds"))
    pos = torch.full((), t - 1, dtype=torch.int64, device=device)

    def decode(params: Any, caches: list, tokens: torch.Tensor,
               pos: torch.Tensor) -> Any:
        return tfm.decode_step(params, caches, tokens, pos, cfg)

    return Step(decode, (params, caches, tokens, pos))


def build(cfg, shape, device: str | torch.device = "meta",
          params: Any = None) -> Step:
    """The cell's step by ``shape.kind``: ``train`` is `build_train`'s
    step on (params, a fresh optimizer state, a batch of ``tokens`` or
    ``embeds`` and int32 ``labels``, `TRAIN_STEP`)."""
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, device, params)
    if shape.kind == "decode":
        return build_decode(cfg, shape, device, params)
    params = param_structs(cfg, device) if params is None else params
    b, t = shape.global_batch, shape.seq_len
    batch = dict(_inputs(cfg, b, t, device),
                 labels=torch.empty((b, t), dtype=torch.int32, device=device))
    return Step(build_train(cfg, shape),
                (params, make_optimizer(cfg).init(params), batch,
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
