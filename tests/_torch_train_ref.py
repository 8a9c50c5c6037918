"""The reference's training step without a mesh, for the port's tests.

`repro/launch/step_builders.py::build_train` needs a mesh (its shardings),
and on this JAX the reference's meshes fail (`parallel/sharding.py`), so
the oracle is its step assembled from the same pieces with no mesh:
``value_and_grad(loss_fn, has_aux=True)``, the microbatch scan of
`build_train` (`:141-163`), ``clip_by_global_norm(grads, 1.0)``, the
config's optimizer at ``warmup_cosine(3e-4, 200, 10_000)(step)`` and
``p + u``.  One jitted step per config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.launch.step_builders import make_optimizer
from repro.models import transformer as RT
from repro.optim import clip_by_global_norm
from repro.optim.schedules import warmup_cosine

from _torch_lm_params import seeded_params


def ref_train_step(cfg):
    """The reference's mesh-free ``train_step(params, opt_state, batch,
    step)`` of ``cfg``, jitted; its metrics also hold ``grads``, the
    (accumulated) gradients before the clip."""
    opt = make_optimizer(cfg)
    lr_fn = warmup_cosine(3e-4, 200, 10_000)
    mb = cfg.microbatches

    def grads_of(params, batch):
        (loss, metrics), grads = jax.value_and_grad(
            RT.loss_fn, has_aux=True)(params, batch, cfg)
        return loss, metrics, grads

    def train_step(params, opt_state, batch, step):
        if mb <= 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            batch_mb = jax.tree.map(
                lambda a: a.reshape(mb, a.shape[0] // mb, *a.shape[1:]),
                batch)

            def one(carry, b_i):
                g_acc, l_acc, c_acc, a_acc = carry
                loss, metrics, grads = grads_of(params, b_i)
                g_acc = jax.tree.map(
                    lambda a, g: a + (g.astype(jnp.float32) / mb
                                      ).astype(a.dtype), g_acc, grads)
                return (g_acc, l_acc + loss / mb, c_acc + metrics["ce"] / mb,
                        a_acc + metrics["aux"] / mb), None

            acc_dt = jnp.dtype(cfg.grad_accum_dtype)
            g0 = jax.tree.map(lambda p: jnp.zeros(p.shape, acc_dt), params)
            z = jnp.zeros((), jnp.float32)
            (grads, loss, ce, aux), _ = jax.lax.scan(
                one, (g0, z, z, z), batch_mb)
            metrics = {"ce": ce, "aux": aux}
        raw = grads
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params,
                                        lr_fn(step))
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm,
                                       grads=raw)

    return jax.jit(train_step), opt


def configs(arch: str, **change):
    """(reference config, port config) of ``arch``, reduced, with the
    same ``change`` on both."""
    from repro_torch.configs import get_config
    ref = dataclasses.replace(ref_get_config(arch).reduce(), **change)
    port = dataclasses.replace(get_config(arch).reduce(), **change)
    return ref, port


def np_params(cfg_ref, seed: int = 1):
    """Seeded numpy weights of ``cfg_ref`` (`seeded_params`)."""
    return jax.tree.map(np.asarray, seeded_params(cfg_ref, seed))


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
