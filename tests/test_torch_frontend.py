"""The embedding-input archs (HuBERT-XLarge, InternVL2-26B) and the
frontend stubs against the JAX reference, on the CPU.

Held: both configs field for field (full and reduced), their counts and
full-size schemas (no ``embed``, an ``out_head``), `supported_shapes`
for every arch (the encoder-only and long-context rules); the
synthetic inputs of `models.frontend` from the reference's threefry keys
(split keys and uniform bits equal; tokens and labels equal but where
exp lands within an ulp of an integer (6 of 120,000 ids); each
normal within 2 ulps of sqrt(2) erfinv(u) in f64 and within 1e-5 of the
reference's, whose own erf_inv is the less exact; embeddings within
1e-5 of max|x| in f32, a bf16 value at most one ulp off); `lm_apply`,
`prefill` and `decode_step` on embeddings against the reference's within
1e-4 (f32), HuBERT's encoder non-causal; prefill + decode steps equal
the full forward (the reference's serve-consistency check); the weight
carrier's round trip of an embedding-input tree.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erfinv

from _torch_lm_params import seeded_params
from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models import frontend as RF
from repro.models import transformer as RT
from repro.models.layers import is_param
from repro_torch.configs import get_config, list_archs
from repro_torch.core import threefry
from repro_torch.models import frontend as TF
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.params import params_from_numpy

LM_RTOL = 1e-4
EMBED_ARCHS = ["hubert-xlarge", "internvl2-26b"]
T, CAP, STEPS = 16, 24, 4


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", EMBED_ARCHS)
def test_config_and_counts_match_the_reference(name, reduced):
    ref, port = ref_get_config(name), get_config(name)
    if reduced:
        ref, port = ref.reduce(), port.reduce()
    fields = {f.name: getattr(port, f.name)
              for f in dataclasses.fields(port)}
    assert set(fields) == {f.name for f in dataclasses.fields(ref)}
    for key, value in fields.items():
        if key in ("segments", "sparsity", "moe"):
            assert repr(value) == repr(getattr(ref, key)), key
        else:
            assert value == getattr(ref, key), key
    assert not port.embed_inputs
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


def _port_shapes(node):
    if isinstance(node, TL.P):
        return node.shape
    if isinstance(node, list):
        return [_port_shapes(v) for v in node]
    return {k: _port_shapes(v) for k, v in node.items()}


@pytest.mark.parametrize("name", EMBED_ARCHS)
def test_schema_matches_the_reference_at_full_size(name):
    port = _port_shapes(TT.lm_schema(get_config(name)))
    ref = jax.tree.map(lambda p: p.shape, RT.lm_schema(ref_get_config(name)),
                       is_leaf=is_param)
    assert port == ref
    assert "embed" not in port and "out_head" in port
    n = get_config(name).param_count()
    assert {"hubert-xlarge": 0.9e9 < n < 1.0e9,
            "internvl2-26b": 19.0e9 < n < 19.6e9}[name]


def test_registry_and_shape_rules_match_the_reference():
    assert list_archs() == sorted(ref_list_archs())
    assert len(list_archs()) == 10
    for name in list_archs():
        assert get_config(name).supported_shapes() == \
            ref_get_config(name).supported_shapes(), name
    sup = get_config("hubert-xlarge").supported_shapes()
    assert sup["decode_32k"] and sup["long_500k"]
    assert not sup["train_4k"] and not sup["prefill_32k"]
    eligible = {a for a in list_archs()
                if not get_config(a).supported_shapes()["long_500k"]}
    assert eligible == {"gemma3-12b", "jamba-v0.1-52b", "rwkv6-3b"}


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 5])
def test_split_and_fold_in_are_the_references(seed):
    key = jax.random.PRNGKey(seed)
    port = threefry.prng_key(seed)
    assert [tuple(int(v) for v in k) for k in
            np.asarray(jax.random.split(key, 5))] == threefry.split(port, 5)
    assert tuple(int(v) for v in np.asarray(jax.random.fold_in(key, 1))) \
        == threefry.fold_in(port, 1)


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_is_the_references(seed):
    key, port = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    shape = (3, 50, 67)
    ref = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = threefry.normal(port, shape).numpy()
    bits = threefry.random_bits(torch.tensor([port]), ref.size)[0]
    u = threefry.uniform(bits, threefry._NORMAL_LO, 1.0).double().numpy()
    exact = (np.sqrt(2.0) * erfinv(u)).reshape(shape)
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - exact) / ulp).max() <= 2.0
    assert _rel(got, ref) <= 1e-5
    assert abs(got.mean()) < 0.05 and abs(got.std() - 1) < 0.05


@pytest.mark.parametrize("seed,b,t,vocab", [(0, 4, 100, 512),
                                            (5, 2, 333, 151936)])
def test_tokens_and_labels_are_the_references(seed, b, t, vocab):
    """The uniform draws bit-equal; a token differs (by one) only where
    exp(u log V) lies within a few ulps of an integer, so the two
    libraries' exp floor to neighbours."""
    key, port = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    u_ref = np.asarray(jax.random.uniform(key, (b, t), jnp.float32, 1e-6,
                                          1.0))
    bits = threefry.random_bits(torch.tensor([port]), b * t)[0]
    u = threefry.uniform(bits, 1e-6, 1.0).reshape(b, t).numpy()
    np.testing.assert_array_equal(u, u_ref)
    for got, ref, uu in (
            (TF.synthetic_tokens(port, b, t, vocab),
             np.asarray(RF.synthetic_tokens(key, b, t, vocab)), u),
            (TF.synthetic_labels(port, b, t, vocab),
             np.asarray(RF.synthetic_labels(jax.random.PRNGKey(seed), b, t,
                                            vocab)), None)):
        assert got.dtype == torch.int32
        diff = got.numpy().astype(np.int64) - ref
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 0.01
        if uu is not None:
            e = np.exp(uu.astype(np.float64) * np.log(float(vocab)))
            near = np.abs(e - np.round(e)) <= 8 * np.spacing(
                e.astype(np.float32))
            assert near[diff != 0].all()


@pytest.mark.parametrize("seed", [0, 11])
def test_embeddings_are_the_references(seed):
    key, port = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    ref = np.asarray(RF.synthetic_embeddings(key, 2, 40, 96, jnp.float32))
    got = TF.synthetic_embeddings(port, 2, 40, 96, torch.float32)
    assert got.shape == (2, 40, 96) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 1e-5
    ref16 = np.asarray(RF.synthetic_embeddings(key, 2, 40, 96)).astype(
        np.float32)
    got16 = TF.synthetic_embeddings(port, 2, 40, 96).float().numpy()
    ulp16 = np.abs(ref16) * 2.0 ** -7 + 1e-30
    assert (np.abs(got16 - ref16) <= ulp16).all()
    assert (got16 != ref16).mean() < 0.01


@functools.lru_cache(maxsize=None)
def _arch(name: str):
    cfg_ref = ref_get_config(name).reduce()
    cfg = get_config(name).reduce()
    np_params = seeded_params(cfg_ref)
    return (cfg_ref, cfg, jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


def _embeds(cfg, b, t, seed=4):
    return np.array(RF.synthetic_embeddings(jax.random.PRNGKey(seed), b,
                                            t, cfg.d_model, jnp.float32))


@pytest.mark.parametrize("name", EMBED_ARCHS)
def test_lm_apply_on_embeddings_matches_the_reference(name):
    """HuBERT's encoder runs non-causal attention (the flash kernel's
    plain version here, ``causal=False``)."""
    cfg_ref, cfg, ref_params, port_params = _arch(name)
    assert cfg.causal == (name != "hubert-xlarge")
    emb = _embeds(cfg, 2, T + STEPS)
    ref = jax.jit(lambda p, e: RT.lm_apply(p, {"embeds": e}, cfg_ref))(
        ref_params, jnp.asarray(emb))
    got = TT.lm_apply(port_params, {"embeds": torch.from_numpy(emb)}, cfg)
    assert got.shape == (2, T + STEPS, cfg.padded_vocab)
    assert _rel(got.numpy(), ref) <= LM_RTOL


@pytest.mark.parametrize("name", EMBED_ARCHS)
def test_prefill_and_decode_on_embeddings_match_the_reference(name):
    cfg_ref, cfg, ref_params, port_params = _arch(name)
    emb = _embeds(cfg, 2, T + STEPS, seed=6)
    logits_r, caches_r = jax.jit(lambda p, e: RT.prefill(
        p, {"embeds": e}, cfg_ref, capacity=CAP))(ref_params,
                                                  jnp.asarray(emb[:, :T]))
    logits, caches = TT.prefill(port_params, {"embeds": torch.from_numpy(
        emb[:, :T])}, cfg, capacity=CAP)
    assert _rel(logits.numpy(), logits_r) <= LM_RTOL
    step = jax.jit(lambda p, c, e, i: RT.decode_step(p, c, e, i, cfg_ref))
    full = TT.lm_apply(port_params, {"embeds": torch.from_numpy(emb)}, cfg)
    for i in range(STEPS):
        e = emb[:, T + i:T + i + 1]
        logits_r, caches_r = step(ref_params, caches_r, jnp.asarray(e),
                                  jnp.int32(T + i))
        logits, caches = TT.decode_step(port_params, caches,
                                        torch.from_numpy(e), T + i, cfg)
        assert _rel(logits.numpy(), logits_r) <= LM_RTOL, i
        if cfg.causal:  # serve consistency: prefill + decode == forward
            assert _rel(logits.numpy(), full[:, T + i].numpy()) <= LM_RTOL


@pytest.mark.parametrize("name", EMBED_ARCHS)
def test_weight_carrier_round_trips_an_embedding_input_tree(name):
    cfg_ref, _, _, port_params = _arch(name)
    np_params = seeded_params(cfg_ref)
    assert "embed" not in port_params and "out_head" in port_params
    flat_np, flat = [], []
    jax.tree.map(flat_np.append, np_params)

    def walk(node):
        if isinstance(node, torch.Tensor):
            flat.append(node)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            for k in sorted(node):
                walk(node[k])

    walk(port_params)
    assert len(flat) == len(flat_np)
    for a, b in zip(flat, flat_np):
        np.testing.assert_array_equal(a.numpy(), b)
    bf = params_from_numpy(seeded_params(dataclasses.replace(
        cfg_ref, param_dtype="bfloat16")), device="cpu")
    assert bf["out_head"].dtype == torch.bfloat16


def test_embeds_are_taken_in_the_configs_dtype():
    _, cfg, _, port_params = _arch("internvl2-26b")
    emb = torch.from_numpy(_embeds(cfg, 1, 8))
    a = TT.lm_apply(port_params, {"embeds": emb}, cfg)
    b = TT.lm_apply(port_params, {"embeds": emb.double()}, cfg)
    assert a.dtype == b.dtype == torch.float32
    assert torch.equal(a, b)
