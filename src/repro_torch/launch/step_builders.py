"""The training step, its optimizer, and the useful-work FLOPs.

The port of the one-device half of `repro/launch/step_builders.py`: its
`build_train` (`:115`) without a mesh — the port has no sharding, so
there are no ShapeDtypeStructs or shardings to build — `make_optimizer`
and `model_flops`.  The prefill and decode builders' counterparts are
`models.transformer.prefill` / `decode_step`, which the server calls.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw,
                                          clip_by_global_norm_, pieces)
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.utils.tree import leaves, tree_unflatten

__all__ = ["make_optimizer", "build_train", "model_flops"]


def make_optimizer(cfg) -> Optimizer:
    if cfg.optimizer == "adafactor":
        return adafactor()
    return adamw()


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


def model_flops(cfg, shape) -> float:
    """6*N_active*D for training, 2*N_active*D for inference (global;
    attention-score FLOPs excluded by convention)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
