"""The port's seven new LM archs against the JAX reference, on the CPU.

Phi-3-medium, Gemma-3-12B, Nemotron-4-340B, Granite-MoE-3B, Kimi-K2,
RWKV-6-3B and Jamba-v0.1, each reduced (`reduce()`: 2 heads or more of
32 (64 attention-free), d_ff 128, 8 experts top-2 of d_ff 64, vocab 512,
f32, windows of 16).  The weights are the reference's `init_params`
draw with its all-zero leaves (norm scales, lerp and decay vectors,
biases) given seeded values, loaded into the port through
`params_from_numpy`.  The reference runs jitted, with no mesh.

Held: configs (every field, `param_count`, `active_param_count`, full
and reduced), the schema's nesting and shapes at full size, `lm_apply`,
`prefill` (logits and every cache leaf) and 8 `decode_step`s, to
relative 1e-5 of max|logit| and of max|cache| (`tests/test_torch_lm.py`'s
bound).  Gemma-3's prefill runs past its window, so its circular caches
wrap in prefill and in decode.  (`tests/test_torch_lm_archs_serve.py`
serves each arch.)
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_params import seeded_params
from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.layers import is_param
from repro_torch.configs import get_config, list_archs
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.params import params_from_numpy

RTOL = 1e-5
NEW_ARCHS = ["phi3-medium-14b", "gemma3-12b", "nemotron-4-340b",
             "granite-moe-3b-a800m", "kimi-k2-1t-a32b", "rwkv6-3b",
             "jamba-v0.1-52b"]
ALL_ARCHS = sorted(NEW_ARCHS + ["qwen1.5-4b"])
T, CAP, STEPS = 24, 40, 8


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _arch(name: str):
    cfg_ref = ref_get_config(name).reduce()
    cfg = get_config(name).reduce()
    np_params = seeded_params(cfg_ref)
    return (cfg_ref, cfg, jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


def _port_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_list_archs_gives_the_eight_token_input_archs():
    token_input = [a for a in list_archs() if get_config(a).embed_inputs]
    assert token_input == ALL_ARCHS
    from repro.configs import list_archs as ref_list_archs
    assert set(token_input) == {
        a for a in ref_list_archs() if ref_get_config(a).embed_inputs}
    assert set(list_archs()) == set(ref_list_archs())


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NEW_ARCHS)
def test_config_and_counts_match_the_reference(name, reduced):
    ref, port = ref_get_config(name), get_config(name)
    if reduced:
        ref, port = ref.reduce(), port.reduce()
    fields = _port_fields(port)
    assert set(fields) == {f.name for f in dataclasses.fields(ref)}
    for key, value in fields.items():
        if key in ("segments", "sparsity"):
            assert repr(value) == repr(getattr(ref, key)), key
        elif key == "moe":
            assert (value is None) == (ref.moe is None)
            if value is not None:
                assert dataclasses.asdict(value) == dataclasses.asdict(
                    ref.moe)
        else:
            assert value == getattr(ref, key), key
    for prop in ("head_dim", "padded_vocab", "total_layers"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


def _port_shapes(node):
    if isinstance(node, TL.P):
        return node.shape
    if isinstance(node, list):
        return [_port_shapes(v) for v in node]
    return {k: _port_shapes(v) for k, v in node.items()}


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_schema_matches_the_reference_at_full_size(name):
    """Nesting and shapes of the whole parameter tree, MoE leaves
    (``router``, ``wi`` (2, E, D, F), ``wo``), ``ffn_shared``, the RWKV and
    Mamba leaves included (shapes only: nothing is allocated)."""
    ref = jax.tree.map(lambda p: p.shape, RT.lm_schema(ref_get_config(name)),
                       is_leaf=is_param)
    assert _port_shapes(TT.lm_schema(get_config(name))) == ref


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_lm_apply_matches_the_reference(name):
    cfg_ref, cfg, ref_params, port_params = _arch(name)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, T))
    ref = jax.jit(lambda p, t: RT.lm_apply(p, {"tokens": t}, cfg_ref))(
        ref_params, jnp.asarray(toks, jnp.int32))
    got = TT.lm_apply(port_params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert got.shape == ref.shape == (2, T, cfg.padded_vocab)
    assert _rel(got, ref) <= RTOL


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [x for k in sorted(tree) for x in _leaves(tree[k])]


def _ref_leaves(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _ref_leaves(v)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _ref_leaves(tree[k])]
    return [tree]


def _caches_close(caches, ref_caches, label):
    got, ref = _leaves(caches), _ref_leaves(ref_caches)
    assert len(got) == len(ref) > 0, label
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape, label
        assert _rel(a, b) <= RTOL, label


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_prefill_and_decode_match_the_reference(name):
    """Prefill logits and every cache leaf (attention K/V, windowed and
    circular; RWKV ``x_prev`` and ``s``; Mamba ``conv`` and ``ssm``), then
    8 decode steps' logits and caches, the port's caches updated in
    place."""
    cfg_ref, cfg, ref_params, port_params = _arch(name)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, T))
    prefill = jax.jit(lambda p, t: RT.prefill(p, {"tokens": t}, cfg_ref,
                                              capacity=CAP))
    decode = jax.jit(lambda p, c, t, pos: RT.decode_step(p, c, t, pos,
                                                         cfg_ref))
    ref_logits, ref_caches = prefill(ref_params, jnp.asarray(toks, jnp.int32))
    logits, caches = TT.prefill(port_params, {"tokens": torch.from_numpy(
        toks)}, cfg, capacity=CAP)
    assert logits.shape == (2, cfg.padded_vocab)
    assert _rel(logits, ref_logits) <= RTOL
    _caches_close(caches, ref_caches, "prefill")
    leaves = _leaves(caches)
    for step in range(STEPS):
        nxt = rng.integers(0, cfg.vocab, (2, 1))
        ref_logits, ref_caches = decode(ref_params, ref_caches,
                                        jnp.asarray(nxt, jnp.int32),
                                        jnp.int32(T + step))
        logits, caches = TT.decode_step(port_params, caches,
                                        torch.from_numpy(nxt), T + step, cfg)
        assert _rel(logits, ref_logits) <= RTOL, step
        _caches_close(caches, ref_caches, f"decode step {step}")
    assert all(a is b for a, b in zip(_leaves(caches), leaves))


def test_gemma3_reduced_windows_wrap():
    """The reduced Gemma-3 above runs its windowed layers' circular caches
    past their capacity: window 16 < T and < the decode positions."""
    cfg = get_config("gemma3-12b").reduce()
    windows = {sp.window for seg in cfg.segments for sp in seg.layers}
    assert windows == {16, None}
    caches = TT.init_cache(cfg, 1, CAP, torch.device("cpu"))
    assert caches[0]["l0"]["mix"]["k"].shape[2] == 16 < T
    assert caches[0]["l5"]["mix"]["k"].shape[2] == CAP


def test_init_params_draws_every_new_law():
    """The port's own seeded init of the new trees: the reference's shapes,
    ``a_log`` rows log(1..16), ``d_skip`` ones, zeros where the reference
    starts at zero."""
    for name in ("jamba-v0.1-52b", "rwkv6-3b", "kimi-k2-1t-a32b"):
        cfg = get_config(name).reduce()
        p = TL.init_params(TT.lm_schema(cfg), 0, device="cpu")
        ref = jax.tree.map(lambda q: tuple(q.shape),
                           RT.lm_schema(ref_get_config(name).reduce()),
                           is_leaf=is_param)
        assert jax.tree.map(lambda t: tuple(t.shape), p) == ref
    mix = TL.init_params(TT.lm_schema(get_config("jamba-v0.1-52b").reduce()),
                         0, device="cpu")["segments"][0]["l0"]["mix"]
    row = torch.log(torch.arange(1, 17, dtype=torch.float32))
    assert torch.equal(mix["a_log"][1, 5], row)
    assert torch.equal(mix["d_skip"], torch.ones_like(mix["d_skip"]))
    assert not mix["conv_b"].any()

