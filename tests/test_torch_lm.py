"""The port's LM stack against the JAX reference, on the CPU.

Reduced Qwen1.5-4B (`reduce()`: 2 layers, d_model 128, 4 heads of 32, SwiGLU
d_ff 128, QKV bias, vocab 512, f32).  The weights are the reference's
`init_params` draw, with the leaves it leaves at zero (norm scales, QKV
biases) given seeded values so both sides see them, loaded into the port
through `params_from_numpy`.  The reference runs with no mesh.

Tolerance: relative 1e-5 of max|logit| (and of max|cache|).  Both sides
compute the same f32 functions; only the order of the f32 sums differs
(the port's prefill attention takes the flash kernel's plain version, the
reference's the jnp flash or the Pallas kernel in interpret mode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.layers import init_params as ref_init_params
from repro_torch.configs import get_config, list_archs
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.params import params_from_numpy

RTOL = 1e-5


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


@pytest.fixture(scope="module")
def lm():
    cfg_ref = ref_get_config("qwen1.5-4b").reduce()
    cfg = get_config("qwen1.5-4b").reduce()
    params = ref_init_params(RT.lm_schema(cfg_ref), jax.random.PRNGKey(0),
                             cfg_ref.dtype)
    rng = np.random.default_rng(1)

    def fill(a):
        a = np.asarray(a)
        if a.any():
            return a
        return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

    np_params = jax.tree.map(fill, params)
    return (cfg_ref, cfg, jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


def _port_cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_the_reference(reduced):
    ref = ref_get_config("qwen1.5-4b")
    port = get_config("qwen1.5-4b")
    if reduced:
        ref, port = ref.reduce(), port.reduce()
    fields = _port_cfg_fields(port)
    for name, value in fields.items():
        if name in ("segments", "sparsity"):
            assert repr(value) == repr(getattr(ref, name)), name
        else:
            assert value == getattr(ref, name), name
    assert set(fields) == {f.name for f in dataclasses.fields(ref)}
    for prop in ("head_dim", "padded_vocab", "total_layers"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.dtype == getattr(torch, str(ref.dtype))
    assert port.cache_dtype == getattr(torch, str(ref.cache_dtype))
    assert list_archs() == ["gemma3-12b", "granite-moe-3b-a800m",
                            "hubert-xlarge", "internvl2-26b",
                            "jamba-v0.1-52b", "kimi-k2-1t-a32b",
                            "nemotron-4-340b", "phi3-medium-14b",
                            "qwen1.5-4b", "rwkv6-3b"]


def test_schema_matches_the_reference_at_full_size():
    """Qwen1.5-4B's parameter tree: the reference's nesting and shapes
    (shapes only — nothing is allocated)."""
    cfg_ref = ref_get_config("qwen1.5-4b")
    ref = RT.lm_schema(cfg_ref)
    port = TT.lm_schema(get_config("qwen1.5-4b"))
    from repro.models.layers import is_param
    ref_shapes = jax.tree.map(lambda p: p.shape, ref, is_leaf=is_param)

    def walk(node):
        if isinstance(node, TL.P):
            return node.shape
        if isinstance(node, list):
            return [walk(v) for v in node]
        return {k: walk(v) for k, v in node.items()}

    assert walk(port) == ref_shapes
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        ref_shapes, is_leaf=lambda x: isinstance(x, tuple)))
    assert n == cfg_ref.param_count()
    assert 3.9e9 < n < 4.0e9


def test_init_params_laws_and_per_slice_draws(lm):
    """The port's own init: the reference's shapes and laws, each slice of
    a stacked leaf drawn from its own generator (seed, path, index)."""
    _, cfg, ref_params, _ = lm
    a = TL.init_params(TT.lm_schema(cfg), 3, device="cpu")
    b = TL.init_params(TT.lm_schema(cfg), 3, device="cpu")
    assert _shapes(a) == _shapes(ref_params)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)
    wq = a["segments"][0]["l0"]["mix"]["wq"]
    assert not torch.equal(wq[0], wq[1])
    p = TL.P(tuple(wq.shape[1:]), ("fsdp", "heads", "head_dim"),
             fan_in=cfg.d_model)
    path = "['segments'][0]['l0']['mix']['wq']"
    assert torch.equal(wq[1], TL._draw(p, p.shape, f"3:{path}:1",
                                       torch.float32))
    d = cfg.d_model
    assert abs(float(a["embed"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(a["out_head"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert not a["final_norm"].any()
    bf = TL.init_params(TT.lm_schema(cfg), 3, dtype=torch.bfloat16,
                        device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    assert torch.equal(bf["embed"], a["embed"].to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_a_reference_lm_tree(dtype):
    """`params_from_numpy` walks the LM tree's list of segments and keeps
    f32 and bfloat16 bits."""
    cfg_ref = ref_get_config("qwen1.5-4b").reduce()
    params = ref_init_params(RT.lm_schema(cfg_ref), jax.random.PRNGKey(2),
                             jnp.dtype(dtype))
    np_params = jax.tree.map(np.asarray, params)
    port = params_from_numpy(np_params, device="cpu")
    assert isinstance(port["segments"], list)
    want = getattr(torch, dtype)
    for a, t in zip(jax.tree.leaves(np_params), jax.tree.leaves(port)):
        assert t.dtype == want
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))


def test_lm_apply_matches_the_reference(lm):
    cfg_ref, cfg, ref_params, port_params = lm
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24))
    ref = RT.lm_apply(ref_params, {"tokens": jnp.asarray(toks, jnp.int32)},
                      cfg_ref)
    got = TT.lm_apply(port_params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert got.shape == ref.shape == (2, 24, cfg.padded_vocab)
    assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("impl,logit_pos", [("xla", None), ("xla", 17),
                                            ("pallas", None)])
def test_prefill_and_decode_match_the_reference(lm, impl, logit_pos):
    """Prefill logits and caches, then 6 decode steps' logits.  The
    reference runs its jnp flash (``xla``) or its Pallas flash kernel in
    interpret mode (``pallas``); the port's attn_impl does not change its
    path."""
    cfg_ref, cfg, ref_params, port_params = lm
    cfg_ref = dataclasses.replace(cfg_ref, attn_impl=impl)
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 24))
    cap = 40
    kw = {} if logit_pos is None else {"logit_pos": logit_pos}
    ref_logits, ref_caches = RT.prefill(
        ref_params, {"tokens": jnp.asarray(toks, jnp.int32)}, cfg_ref,
        capacity=cap, **({} if logit_pos is None
                         else {"logit_pos": jnp.int32(logit_pos)}))
    logits, caches = TT.prefill(port_params,
                                {"tokens": torch.from_numpy(toks)}, cfg,
                                capacity=cap, **kw)
    assert logits.shape == (2, cfg.padded_vocab)
    assert _rel(logits, ref_logits) <= RTOL
    for name in ("k", "v"):
        got = caches[0]["l0"]["mix"][name]
        ref = ref_caches[0]["l0"]["mix"][name]
        assert tuple(got.shape) == ref.shape == (2, 2, cap, 4, 32)
        assert _rel(got, ref) <= RTOL
    for step in range(6):
        nxt = rng.integers(0, cfg.vocab, (2, 1))
        ref_logits, ref_caches = RT.decode_step(
            ref_params, ref_caches, jnp.asarray(nxt, jnp.int32),
            jnp.int32(24 + step), cfg_ref)
        logits, caches = TT.decode_step(port_params, caches,
                                        torch.from_numpy(nxt), 24 + step, cfg)
        assert _rel(logits, ref_logits) <= RTOL, step
    assert _rel(caches[0]["l0"]["mix"]["k"],
                ref_caches[0]["l0"]["mix"]["k"]) <= RTOL


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "relu2", "gelu",
                                        "relu"])
def test_mlp_apply_matches_the_reference(activation):
    from repro.models import layers as RL
    rng = np.random.default_rng(11)
    d, f = 32, 48
    gated = activation in ("swiglu", "geglu")
    wi = rng.standard_normal((2, d, f) if gated else (d, f)) * d ** -0.5
    wo = rng.standard_normal((f, d)) * f ** -0.5
    x = rng.standard_normal((2, 5, d))
    params = {"wi": wi.astype(np.float32), "wo": wo.astype(np.float32)}
    ref = RL.mlp_apply(jax.tree.map(jnp.asarray, params),
                       jnp.asarray(x, jnp.float32), activation=activation)
    got = TL.mlp_apply(params_from_numpy(params, device="cpu"),
                       torch.from_numpy(x.astype(np.float32)),
                       activation=activation)
    assert _rel(got, ref) <= RTOL


def test_rms_norm_and_rope_match_the_reference():
    from repro.models import layers as RL
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(100, 107)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(RL.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    for theta in (1e4, 1e6):
        got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos),
                      theta=theta)
        ref = RL.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
        assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("kv_heads,qk_norm,window", [(4, False, None),
                                                     (2, True, None),
                                                     (2, False, 8)])
def test_attention_apply_matches_the_reference(kv_heads, qk_norm, window):
    """One attention layer, prefill then decode steps, with grouped KV
    heads, qk-norm and a sliding window over a circular cache (the Gemma-3
    and Phi-3 paths, held at the module level)."""
    from repro.models import attention as RA
    cfg_ref = dataclasses.replace(ref_get_config("qwen1.5-4b").reduce(),
                                  n_kv_heads=kv_heads, qk_norm=qk_norm)
    cfg = dataclasses.replace(get_config("qwen1.5-4b").reduce(),
                              n_kv_heads=kv_heads, qk_norm=qk_norm)
    rng = np.random.default_rng(13 + kv_heads)
    schema = RA.attn_schema(cfg_ref)
    params = {k: (rng.standard_normal(p.shape) * 0.2).astype(np.float32)
              for k, p in schema.items()}
    rp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    t, cap = 12, 8 if window else 20
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    ref_y, ref_c = RA.attention_apply(rp, jnp.asarray(x), cfg_ref,
                                      window=window, cache_capacity=cap)
    y, c = TA.attention_apply(tp, torch.from_numpy(x), cfg, window=window,
                              cache_capacity=cap)
    assert _rel(y, ref_y) <= RTOL
    assert _rel(c["k"], ref_c["k"]) <= RTOL
    for step in range(4):
        xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        ref_y, ref_c = RA.attention_apply(rp, jnp.asarray(xd), cfg_ref,
                                          window=window, cache=ref_c,
                                          pos=jnp.int32(t + step),
                                          decode=True)
        y, c = TA.attention_apply(tp, torch.from_numpy(xd), cfg,
                                  window=window, cache=c, pos=t + step,
                                  decode=True)
        assert _rel(y, ref_y) <= RTOL, step
        assert _rel(c["v"], ref_c["v"]) <= RTOL, step
