"""``bf16_flow`` (matmul outputs in the activations' dtype) against the
JAX reference, on the CPU.

Held: `precision_flow` sets and restores `matmul_out_dtype` (nested, and
on an exception); `lm_apply`, `prefill` and `decode_step` of reduced
archs with ``bf16_flow=True`` against the reference's within 1e-4 (f32,
where the two settings are one function); in bf16, the port against the
reference with the flag on, within 2e-2 of max|logit| (the bound of the
bf16 prefill checks on the card), for the archs whose sites differ
between the settings (Granite-MoE's expert gate, RWKV-6's g, k and v)
and for Qwen1.5-4B, whose sites do not: there the port's logits are
bit-equal with the flag on and off; the MoE expert FFN and the RWKV
channel mix alone against the reference's under each setting.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_lm_params import seeded_params
from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro.models import rwkv as RRWKV
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import rwkv as TRWKV
from repro_torch.models import transformer as TT
from repro_torch.params import params_from_numpy

LM_RTOL = 1e-4
BF16_RTOL = 2e-2
FLOW_ARCHS = ["qwen1.5-4b", "granite-moe-3b-a800m", "rwkv6-3b"]
T, CAP, STEPS = 12, 20, 3


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_precision_flow_sets_and_restores_the_output_dtype():
    assert TL.matmul_out_dtype() == torch.float32
    with TL.precision_flow(True):
        assert TL.matmul_out_dtype() is None
        with TL.precision_flow(False):
            assert TL.matmul_out_dtype() == torch.float32
        assert TL.matmul_out_dtype() is None
    assert TL.matmul_out_dtype() == torch.float32
    with pytest.raises(RuntimeError):
        with TL.precision_flow(True):
            raise RuntimeError
    assert TL.matmul_out_dtype() == torch.float32
    a = torch.randn(3, 8).bfloat16()
    b = torch.randn(8, 5).bfloat16()
    assert TL.matmul_out(a, b).dtype == torch.float32
    with TL.precision_flow(True):
        assert TL.matmul_out(a, b).dtype == torch.bfloat16
        assert TL.dense_out(a, b.reshape(8, 5, 1)).shape == (3, 5, 1)


@functools.lru_cache(maxsize=None)
def _arch(name: str, dtype: str):
    kw = dict(bf16_flow=True, param_dtype=dtype, cache_dtype_str=dtype)
    cfg_ref = dataclasses.replace(ref_get_config(name).reduce(), **kw)
    cfg = dataclasses.replace(get_config(name).reduce(), **kw)
    np_params = seeded_params(cfg_ref)
    return (cfg_ref, cfg, jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("name", FLOW_ARCHS)
def test_bf16_flow_forward_prefill_and_decode_match_the_reference_f32(name):
    cfg_ref, cfg, ref_params, port_params = _arch(name, "float32")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, T + STEPS))
    ref = jax.jit(lambda p, t: RT.lm_apply(p, {"tokens": t}, cfg_ref))(
        ref_params, jnp.asarray(toks, jnp.int32))
    got = TT.lm_apply(port_params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert _rel(got.numpy(), ref) <= LM_RTOL
    logits_r, caches_r = jax.jit(lambda p, t: RT.prefill(
        p, {"tokens": t}, cfg_ref, capacity=CAP))(
        ref_params, jnp.asarray(toks[:, :T], jnp.int32))
    logits, caches = TT.prefill(port_params, {"tokens": torch.from_numpy(
        toks[:, :T])}, cfg, capacity=CAP)
    assert _rel(logits.numpy(), logits_r) <= LM_RTOL
    step = jax.jit(lambda p, c, t, i: RT.decode_step(p, c, t, i, cfg_ref))
    for i in range(STEPS):
        tok = toks[:, T + i:T + i + 1]
        logits_r, caches_r = step(ref_params, caches_r,
                                  jnp.asarray(tok, jnp.int32),
                                  jnp.int32(T + i))
        logits, caches = TT.decode_step(port_params, caches,
                                        torch.from_numpy(tok), T + i, cfg)
        assert _rel(logits.numpy(), logits_r) <= LM_RTOL, i


@pytest.mark.parametrize("name", FLOW_ARCHS)
def test_bf16_flow_in_bf16_is_the_references_within_the_bf16_bound(name):
    cfg_ref, cfg, ref_params, port_params = _arch(name, "bfloat16")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, T))
    ref = jax.jit(lambda p, t: RT.lm_apply(p, {"tokens": t}, cfg_ref))(
        ref_params, jnp.asarray(toks, jnp.int32))
    batch = {"tokens": torch.from_numpy(toks)}
    got = TT.lm_apply(port_params, batch, cfg)
    assert _rel(_f32(got), _f32(ref)) <= BF16_RTOL
    off = TT.lm_apply(port_params, batch,
                      dataclasses.replace(cfg, bf16_flow=False))
    if name == "qwen1.5-4b":  # no site where the two settings differ
        assert torch.equal(got, off)
    else:
        assert not torch.equal(got, off)


@pytest.mark.parametrize("flow", [False, True])
@pytest.mark.parametrize("gated", [True, False])
def test_expert_ffn_matches_the_reference_under_each_setting(flow, gated):
    rng = np.random.default_rng(2)
    e, c, d, f = 3, 5, 32, 48
    x = rng.standard_normal((e, c, d)).astype(jnp.bfloat16)
    wi = (rng.standard_normal(((2,) if gated else ()) + (e, d, f)) / 6
          ).astype(jnp.bfloat16)
    wo = (rng.standard_normal((e, f, d)) / 7).astype(jnp.bfloat16)
    with RL.precision_flow(flow):
        ref = RMOE._expert_ffn(jnp.asarray(x), jnp.asarray(wi),
                               jnp.asarray(wo), gated=gated,
                               activation_fn=jax.nn.silu)
    t = params_from_numpy({"x": x, "wi": wi, "wo": wo}, device="cpu")
    with TL.precision_flow(flow):
        got = TMOE._expert_ffn(t["x"], t["wi"], t["wo"], gated=gated,
                               activation_fn=F.silu)
    assert got.dtype == torch.bfloat16
    assert _rel(_f32(got), _f32(ref)) <= BF16_RTOL


@pytest.mark.parametrize("flow", [False, True])
def test_rwkv_channel_mix_matches_the_reference_under_each_setting(flow):
    cfg_ref, cfg, ref_params, port_params = _arch("rwkv6-3b", "bfloat16")
    cfg_ref = dataclasses.replace(cfg_ref, bf16_flow=flow)
    cfg = dataclasses.replace(cfg, bf16_flow=flow)
    x = np.random.default_rng(3).standard_normal(
        (2, 6, cfg.d_model)).astype(jnp.bfloat16)
    p_ref = jax.tree.map(lambda a: a[0],
                         ref_params["segments"][0]["l0"]["ffn"])
    p = {k: v[0] for k, v in port_params["segments"][0]["l0"]["ffn"].items()}
    with RL.precision_flow(flow):
        ref, _ = RRWKV.rwkv_channel_mix(p_ref, jnp.asarray(x), cfg_ref)
    with TL.precision_flow(flow):
        got, _ = TRWKV.rwkv_channel_mix(
            p, params_from_numpy({"x": x}, device="cpu")["x"], cfg)
    assert _rel(_f32(got), _f32(ref)) <= BF16_RTOL
