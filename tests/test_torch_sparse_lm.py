"""The vector-sparse FFN (`models.sparse_lm`) against the JAX reference,
on the CPU.

Held: the sparse schema's nesting and shapes at full size for every LM
arch with ``use_sparse_ffn=True``, and its ``vs_idx`` init (the
reference's values); `sparse_mlp_apply` against the reference's
``ctx is None`` path on reduced Qwen1.5-4B (gated) and Nemotron-4 (relu2)
with ``tp_hint=2``, so that the ``wo`` merge (`merge_wo`) joins two
shard CSRs — f32 within relative 1e-5, bf16 within the noise floor (the
reference's own bf16 output against its f32 one) — and against the
densified numpy product; `lm_apply`, `prefill` and `decode_step` of the
reduced sparse archs against the reference's within 1e-4 (f32); the
parameter count's scaling with the density; the weight carrier's round
trip of the sparse tree; `Server` serving the sparse Qwen with the
reference's greedy tokens (the reference's `LMBackend` with no mesh)
and refusing an embedding-input arch.  (`tests/test_torch_vsmm_bf16.py`
holds the kernel.)
"""
import contextlib
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_params import seeded_params
from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.launch import serve as RS
from repro.launch.scheduler import LockstepScheduler as RefScheduler
from repro.models import sparse_lm as RSL
from repro.models import transformer as RT
from repro.models.layers import _leaf_init as ref_leaf_init
from repro.models.layers import init_params as ref_init_params
from repro.models.layers import is_param
from repro_torch.configs import get_config, list_archs
from repro_torch.core.vector_sparse import VectorSparse, decode
from repro_torch.launch import serve as TS
from repro_torch.models import layers as TL
from repro_torch.models import sparse_lm as TSL
from repro_torch.models import transformer as TT
from repro_torch.params import params_from_numpy

RTOL = 1e-5
LM_RTOL = 1e-4
SPARSE_ARCHS = ["qwen1.5-4b", "nemotron-4-340b"]
T, CAP, STEPS = 16, 32, 4


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _sparse(cfg, **kw):
    return dataclasses.replace(cfg, use_sparse_ffn=True, **kw)


def _port_shapes(node):
    if isinstance(node, TL.P):
        return node.shape
    if isinstance(node, list):
        return [_port_shapes(v) for v in node]
    return {k: _port_shapes(v) for k, v in node.items()}


@pytest.mark.parametrize("name", sorted(list_archs()))
def test_sparse_schema_matches_the_reference_at_full_size(name):
    ref_cfg = _sparse(ref_get_config(name))
    cfg = _sparse(get_config(name))
    ref = jax.tree.map(lambda p: p.shape, RT.lm_schema(ref_cfg),
                       is_leaf=is_param)
    assert _port_shapes(TT.lm_schema(cfg)) == ref
    assert cfg.param_count() == ref_cfg.param_count()


def _idx_leaves(schema, path=""):
    if isinstance(schema, TL.P):
        return [(path, schema)] if schema.init == "vs_idx" else []
    if isinstance(schema, list):
        return [x for i, v in enumerate(schema)
                for x in _idx_leaves(v, f"{path}[{i}]")]
    return [x for k, v in schema.items()
            for x in _idx_leaves(v, f"{path}[{k!r}]")]


@pytest.mark.parametrize("name", SPARSE_ARCHS + ["phi3-medium-14b"])
def test_vs_idx_init_is_the_references(name):
    """Every ``wi_idx`` / ``wo_idx`` leaf at full size (a few thousand
    int32 values each): the reference's evenly spaced, sorted K-tiles."""
    cfg = _sparse(get_config(name))
    leaves = _idx_leaves(TT.lm_schema(cfg))
    assert {p.split("]")[-2] for p, _ in leaves} == {"['wi_idx'",
                                                      "['wo_idx'"}
    ref_schema = RT.lm_schema(_sparse(ref_get_config(name)))
    ref_leaves = {jax.tree_util.keystr(path): p for path, p in
                  jax.tree_util.tree_flatten_with_path(
                      ref_schema, is_leaf=is_param)[0]}
    for path, p in leaves:
        got = TL.init_params({"a": p}, 0, device="cpu")["a"]
        ref = ref_leaf_init(ref_leaves[path], jax.random.PRNGKey(0), path,
                            jnp.float32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _ffn_cfgs(name, dtype="float32"):
    ref = dataclasses.replace(ref_get_config(name).reduce(), tp_hint=2,
                              d_ff=128, d_model=64, param_dtype=dtype)
    port = dataclasses.replace(get_config(name).reduce(), tp_hint=2,
                               d_ff=128, d_model=64, param_dtype=dtype)
    return ref, port


def _ffn_params(cfg_ref, dtype):
    params = ref_init_params(RSL.sparse_mlp_schema(cfg_ref,
                                                   cfg_ref.sparsity),
                             jax.random.PRNGKey(0), dtype)
    return jax.tree.map(np.array, params)


def _x(dtype, d=64):
    return np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 8, d),
                                      jnp.float32).astype(dtype))


@pytest.mark.parametrize("name", SPARSE_ARCHS)
def test_sparse_mlp_matches_the_reference_f32(name):
    cfg_ref, cfg = _ffn_cfgs(name)
    np_params = _ffn_params(cfg_ref, jnp.float32)
    assert np_params["wo_vals"].shape[0] == 2
    x = _x(jnp.float32)
    ref = RSL.sparse_mlp_apply(jax.tree.map(jnp.asarray, np_params),
                               jnp.asarray(x), cfg_ref)
    params = params_from_numpy(np_params, device="cpu")
    got = TSL.sparse_mlp_apply(params, torch.from_numpy(x), cfg)
    assert _rel(got.numpy(), ref) <= RTOL
    merged = TSL.prepare_sparse_mlp(params, cfg)
    assert set(merged) == {"wi_vals", "wi_idx", "wo_csr_vals", "wo_csr_idx"}
    again = TSL.sparse_mlp_apply(merged, torch.from_numpy(x), cfg)
    assert torch.equal(again, got)


@pytest.mark.parametrize("name", SPARSE_ARCHS)
def test_sparse_mlp_matches_the_reference_bf16(name):
    """bf16 weights and activations: within the noise floor, the
    distance between the reference's bf16 output and its f32 output on
    the same (bf16-valued) numbers."""
    cfg_ref, cfg = _ffn_cfgs(name, "bfloat16")
    np_params = _ffn_params(cfg_ref, jnp.bfloat16)
    x = _x(jnp.bfloat16)
    jp = jax.tree.map(jnp.asarray, np_params)
    ref = RSL.sparse_mlp_apply(jp, jnp.asarray(x), cfg_ref)
    ref32 = RSL.sparse_mlp_apply(
        jax.tree.map(lambda a: a.astype(jnp.float32)
                     if a.dtype == jnp.bfloat16 else a, jp),
        jnp.asarray(x, jnp.float32), cfg_ref)
    floor = _rel(np.asarray(ref, np.float32), ref32)
    params = params_from_numpy(np_params, device="cpu")
    got = TSL.sparse_mlp_apply(params, params_from_numpy(
        {"x": x}, device="cpu")["x"], cfg)
    assert got.dtype == torch.bfloat16
    assert 0 < floor < 1e-2
    assert _rel(got.float().numpy(), np.asarray(ref, np.float32)) <= floor


def _densify(vals, idx, k):
    vals, idx = np.asarray(vals, np.float32), np.asarray(idx)
    nb, s, vk, vn = vals.shape
    w = np.zeros((k // vk, vk, nb, vn), np.float32)
    for j in range(nb):
        for t in range(s):
            w[idx[j, t], :, j, :] += vals[j, t]
    return w.reshape(k, nb * vn)


@pytest.mark.parametrize("name", SPARSE_ARCHS)
def test_sparse_mlp_matches_the_densified_product(name):
    cfg_ref, cfg = _ffn_cfgs(name)
    p = _ffn_params(cfg_ref, jnp.float32)
    x = _x(jnp.float32)
    xf = x.reshape(-1, 64).astype(np.float64)
    if p["wi_vals"].ndim == 5:
        g = xf @ _densify(p["wi_vals"][0], p["wi_idx"][0], 64)
        u = xf @ _densify(p["wi_vals"][1], p["wi_idx"][1], 64)
        h = g / (1 + np.exp(-g)) * u
    else:
        h = np.maximum(xf @ _densify(p["wi_vals"], p["wi_idx"], 64), 0) ** 2
    f_loc = cfg.d_ff // cfg.tp_hint
    wo = np.concatenate([_densify(p["wo_vals"][r], p["wo_idx"][r], f_loc)
                         for r in range(cfg.tp_hint)], axis=0)
    ref = (h @ wo).reshape(2, 8, 64)
    got = TSL.sparse_mlp_apply(params_from_numpy(p, device="cpu"),
                               torch.from_numpy(x), cfg)
    assert _rel(got.numpy(), ref) <= LM_RTOL
    # the merged CSR is the shard CSRs stacked along K
    vals, idx = TSL.merge_wo(torch.from_numpy(p["wo_vals"]),
                             torch.from_numpy(p["wo_idx"]), cfg.d_ff)
    dense = decode(VectorSparse(vals, idx, (cfg.d_ff, 64))).numpy()
    np.testing.assert_array_equal(dense, wo.astype(np.float32))


def test_merge_wo_keeps_a_layer_stack():
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.standard_normal((3, 4, 2, 5, 8, 16)))
    idx = torch.from_numpy(rng.integers(0, 6, (3, 4, 2, 5))).int()
    mv, mi = TSL.merge_wo(vals, idx, 4 * 6 * 8)
    assert mv.shape == (3, 2, 20, 8, 16) and mi.shape == (3, 2, 20)
    assert mv.is_contiguous() and mi.dtype == torch.int32
    for layer in range(3):
        for r in range(4):
            assert torch.equal(mv[layer, :, 5 * r:5 * (r + 1)],
                               vals[layer, r])
            assert torch.equal(mi[layer, :, 5 * r:5 * (r + 1)],
                               idx[layer, r] + 6 * r)


@functools.lru_cache(maxsize=None)
def _arch(name: str):
    cfg_ref = _sparse(ref_get_config(name).reduce(), tp_hint=2)
    cfg = _sparse(get_config(name).reduce(), tp_hint=2)
    np_params = seeded_params(cfg_ref)
    return (cfg_ref, cfg, jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


@pytest.mark.parametrize("name", SPARSE_ARCHS)
def test_sparse_lm_apply_prefill_and_decode_match_the_reference(name):
    cfg_ref, cfg, ref_params, port_params = _arch(name)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, T + STEPS))
    ref = jax.jit(lambda p, t: RT.lm_apply(p, {"tokens": t}, cfg_ref))(
        ref_params, jnp.asarray(toks, jnp.int32))
    got = TT.lm_apply(port_params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert _rel(got.numpy(), ref) <= LM_RTOL
    served = TT.prepare_params(port_params, cfg)
    assert "wo_csr_vals" in served["segments"][0]["l0"]["ffn"]
    assert "wo_vals" in port_params["segments"][0]["l0"]["ffn"]
    logits_r, caches_r = jax.jit(lambda p, t: RT.prefill(
        p, {"tokens": t}, cfg_ref, capacity=CAP))(
        ref_params, jnp.asarray(toks[:, :T], jnp.int32))
    logits, caches = TT.prefill(served, {"tokens": torch.from_numpy(
        toks[:, :T])}, cfg, capacity=CAP)
    assert _rel(logits.numpy(), logits_r) <= LM_RTOL
    step = jax.jit(lambda p, c, t, i: RT.decode_step(p, c, t, i, cfg_ref))
    for i in range(STEPS):
        tok = toks[:, T + i:T + i + 1]
        logits_r, caches_r = step(ref_params, caches_r,
                                  jnp.asarray(tok, jnp.int32),
                                  jnp.int32(T + i))
        logits, caches = TT.decode_step(served, caches,
                                        torch.from_numpy(tok), T + i, cfg)
        assert _rel(logits.numpy(), logits_r) <= LM_RTOL, i


def test_param_count_scales_with_density():
    base = dataclasses.replace(get_config("nemotron-4-340b").reduce(),
                               tp_hint=2, d_ff=256, d_model=128)
    dense_ffn = 2 * 128 * 256  # wi + wo elements a layer
    counts = {}
    for density in (1.0, 0.5, 0.25):
        sp = dataclasses.replace(base.sparsity, density=density)
        cfg = _sparse(base, sparsity=sp)
        schema = TSL.sparse_mlp_schema(cfg, sp)
        vals = sum(math.prod(schema[k].shape)
                   for k in ("wi_vals", "wo_vals"))
        assert vals == round(dense_ffn * density)
        counts[density] = cfg.param_count()
        ref_cfg = _sparse(dataclasses.replace(
            ref_get_config("nemotron-4-340b").reduce(), tp_hint=2,
            d_ff=256, d_model=128), sparsity=dataclasses.replace(
                ref_get_config("nemotron-4-340b").sparsity,
                density=density))
        assert counts[density] == ref_cfg.param_count()
    assert counts[1.0] > counts[0.5] > counts[0.25]


def test_weight_carrier_round_trips_the_sparse_tree():
    cfg_ref, cfg, _, port_params = _arch("qwen1.5-4b")
    np_params = seeded_params(cfg_ref)
    ffn_np = np_params["segments"][0]["l0"]["ffn"]
    ffn = port_params["segments"][0]["l0"]["ffn"]
    assert set(ffn) == {"wi_vals", "wi_idx", "wo_vals", "wo_idx"}
    assert ffn["wi_idx"].dtype == ffn["wo_idx"].dtype == torch.int32
    assert ffn["wi_vals"].shape[:2] == (2, 2)        # (repeat, gate/up)
    assert ffn["wo_vals"].shape[:2] == (2, 2)        # (repeat, tp)
    for key in ffn:
        np.testing.assert_array_equal(ffn[key].numpy(), ffn_np[key])
    bf = dataclasses.replace(cfg_ref, param_dtype="bfloat16")
    bf_np = seeded_params(bf)["segments"][0]["l0"]["ffn"]
    back = params_from_numpy(bf_np, device="cpu")
    assert back["wi_vals"].dtype == torch.bfloat16
    assert back["wi_idx"].dtype == torch.int32
    np.testing.assert_array_equal(
        back["wo_vals"].view(torch.int16).numpy(),
        bf_np["wo_vals"].view(np.int16))


class _MeshFreeLMBackend(RS.LMBackend):
    """The reference backend, run with no mesh."""

    def context(self):
        return contextlib.nullcontext()


def test_server_serves_the_sparse_qwen_with_the_references_tokens():
    cfg_ref, cfg, ref_params, port_params = _arch("qwen1.5-4b")
    rng = np.random.default_rng(0)
    traffic = [(i, rng.integers(0, cfg.vocab, int(rng.integers(10, 20)),
                                dtype=np.int32), int(rng.integers(3, 7)))
               for i in range(4)]
    be = _MeshFreeLMBackend(cfg_ref, ref_params, None, capacity=CAP)
    ref_reqs = [RS.Request(rid=r, prompt=p, max_new=m)
                for r, p, m in traffic]
    ref_stats = RefScheduler(be, batch=2).serve(ref_reqs)
    srv = TS.Server(cfg, batch=2, capacity=CAP, device="cpu",
                    params=port_params)
    assert "wo_csr_vals" in srv.params["segments"][0]["l0"]["ffn"]
    reqs = [TS.Request(rid=r, prompt=p, max_new=m) for r, p, m in traffic]
    stats = srv.serve(reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert [s["steps"] for s in ref_stats] == \
        [s["decode_steps"] for s in stats]


@pytest.mark.parametrize("name", ["hubert-xlarge", "internvl2-26b"])
def test_server_refuses_embedding_input_archs(name):
    with pytest.raises(ValueError, match="token-input"):
        TS.Server(get_config(name).reduce(), batch=2, capacity=CAP,
                  device="cpu")
