"""The port's RWKV-6 mixers against the JAX reference's, on the CPU.

The time mix and the channel mix of reduced RWKV-6-3B (d_model 256, 4
heads of 64, d_ff 128, f32), with every leaf, the reference's zero-init
vectors included, drawn from numpy: the full-sequence forward, prefill
(output and the caches ``x_prev`` and ``s``) and decode steps from the
prefilled caches, each within relative 1e-5 of max|y| and of max|cache|.
The port's decode writes its caches in place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import rwkv as RR
from repro_torch.configs import get_config
from repro_torch.models import rwkv as TR
from repro_torch.params import params_from_numpy

RTOL = 1e-5
B, T = 2, 19


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _params(schema, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in schema.items():
        scale = 0.3 if p.init == "zeros" else (p.fan_in or p.shape[0]) ** -0.5
        out[name] = (scale * rng.standard_normal(p.shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def cfgs():
    return (ref_get_config("rwkv6-3b").reduce(),
            get_config("rwkv6-3b").reduce())


@pytest.mark.parametrize("mix", ["time", "channel"])
def test_mix_matches_the_reference_in_every_mode(cfgs, mix):
    cfg_ref, cfg = cfgs
    ref_fn, fn = ((RR.rwkv_time_mix, TR.rwkv_time_mix) if mix == "time"
                  else (RR.rwkv_channel_mix, TR.rwkv_channel_mix))
    schema = (RR.rwkv_tm_schema if mix == "time" else RR.rwkv_cm_schema)(
        cfg_ref)
    port_schema = (TR.rwkv_tm_schema if mix == "time"
                   else TR.rwkv_cm_schema)(cfg)
    assert {k: p.shape for k, p in port_schema.items()} == \
        {k: p.shape for k, p in schema.items()}
    np_params = _params(schema, 3 if mix == "time" else 4)
    rp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)

    ref_y, _ = ref_fn(rp, jnp.asarray(x), cfg_ref)
    y, nc = fn(tp, torch.from_numpy(x), cfg)
    assert nc is None and _rel(y, ref_y) <= RTOL

    ref_y, ref_c = ref_fn(rp, jnp.asarray(x), cfg_ref, prefill=True)
    y, c = fn(tp, torch.from_numpy(x), cfg, prefill=True)
    assert _rel(y, ref_y) <= RTOL
    assert set(c) == set(ref_c)
    for k in c:
        assert tuple(c[k].shape) == ref_c[k].shape
        assert _rel(c[k], ref_c[k]) <= RTOL, k
    held = dict(c)
    for step in range(4):
        xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        ref_y, ref_c = ref_fn(rp, jnp.asarray(xd), cfg_ref, cache=ref_c,
                              decode=True)
        y, c = fn(tp, torch.from_numpy(xd), cfg, cache=c, decode=True)
        assert _rel(y, ref_y) <= RTOL, step
        for k in c:
            assert c[k] is held[k]                # written in place
            assert _rel(c[k], ref_c[k]) <= RTOL, (step, k)


def test_caches_have_the_reference_shapes_and_dtypes(cfgs):
    cfg_ref, cfg = cfgs
    ref = RR.init_rwkv_tm_cache(cfg_ref, 3, jnp.bfloat16)
    got = TR.init_rwkv_tm_cache(cfg, 3, torch.bfloat16, torch.device("cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in ref.items()}
    ref = RR.init_rwkv_cm_cache(cfg_ref, 3, jnp.float32)
    got = TR.init_rwkv_cm_cache(cfg, 3, torch.float32, torch.device("cpu"))
    assert tuple(got["x_prev"].shape) == ref["x_prev"].shape
