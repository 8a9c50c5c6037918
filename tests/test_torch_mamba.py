"""The port's Mamba mixer against the JAX reference's, on the CPU.

`mamba_apply` of reduced Jamba-v0.1 (d_model 128, d_inner 256, state 16,
conv width 4, dt rank 8, f32), every leaf drawn from numpy (``a_log``
by the reference's law): the full-sequence forward, prefill (output and
the caches ``conv`` and ``ssm``) and decode steps from the prefilled
caches, each within relative 1e-5 of max|y| and of max|cache|.  The
port's decode writes its caches in place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import mamba as RMB
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMB
from repro_torch.params import params_from_numpy

RTOL = 1e-5
B = 2


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    cfg_ref = ref_get_config("jamba-v0.1-52b").reduce()
    cfg = get_config("jamba-v0.1-52b").reduce()
    schema = RMB.mamba_schema(cfg_ref)
    port_schema = TMB.mamba_schema(cfg)
    assert {k: (p.shape, p.init) for k, p in port_schema.items()} == \
        {k: (p.shape, p.init) for k, p in schema.items()}
    rng = np.random.default_rng(7)
    params = {}
    for name, p in schema.items():
        if p.init == "a_log":
            params[name] = TL._draw(port_schema[name], p.shape, "",
                                    torch.float32).numpy()
        else:
            scale = 0.3 if p.init in ("zeros", "ones") else \
                (p.fan_in or p.shape[0]) ** -0.5
            params[name] = (scale * rng.standard_normal(p.shape)).astype(
                np.float32)
    ref_a_log = RMB.mamba_schema(cfg_ref)["a_log"]
    from repro.models.layers import _leaf_init
    # the law: the same rows, up to an ulp of the two sides' logarithms
    np.testing.assert_allclose(
        params["a_log"],
        np.asarray(_leaf_init(ref_a_log, jax.random.PRNGKey(0), "a",
                              jnp.float32)), rtol=2e-7, atol=0)
    return (cfg_ref, cfg, jax.tree.map(jnp.asarray, params),
            params_from_numpy(params, device="cpu"))


@pytest.mark.parametrize("t", [3, 16, 21])
def test_mamba_apply_matches_the_reference_in_every_mode(setup, t):
    cfg_ref, cfg, rp, tp = setup
    rng = np.random.default_rng(t)
    x = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    ref_y, _ = RMB.mamba_apply(rp, jnp.asarray(x), cfg_ref)
    y, nc = TMB.mamba_apply(tp, torch.from_numpy(x), cfg)
    assert nc is None and _rel(y, ref_y) <= RTOL

    ref_y, ref_c = RMB.mamba_apply(rp, jnp.asarray(x), cfg_ref, prefill=True)
    y, c = TMB.mamba_apply(tp, torch.from_numpy(x), cfg, prefill=True)
    assert _rel(y, ref_y) <= RTOL
    for k in ("conv", "ssm"):
        assert tuple(c[k].shape) == ref_c[k].shape
        assert _rel(c[k], ref_c[k]) <= RTOL, k
    held = dict(c)
    for step in range(5):
        xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        ref_y, ref_c = RMB.mamba_apply(rp, jnp.asarray(xd), cfg_ref,
                                       cache=ref_c, decode=True)
        y, c = TMB.mamba_apply(tp, torch.from_numpy(xd), cfg, cache=c,
                               decode=True)
        assert _rel(y, ref_y) <= RTOL, step
        for k in ("conv", "ssm"):
            assert c[k] is held[k]                # written in place
            assert _rel(c[k], ref_c[k]) <= RTOL, (step, k)


def test_cache_has_the_reference_shapes(setup):
    cfg_ref, cfg, _, _ = setup
    ref = RMB.init_mamba_cache(cfg_ref, 3, jnp.bfloat16)
    got = TMB.init_mamba_cache(cfg, 3, torch.bfloat16, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert got["conv"].dtype == torch.bfloat16
    assert got["ssm"].dtype == torch.float32
