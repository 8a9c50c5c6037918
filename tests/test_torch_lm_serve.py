"""The port's LM `Server` against the JAX reference's serving, on the CPU.

The reference's `Server` enters a device mesh whose sharding constraints
fail on this tree's jax, so the oracle is the reference's `LMBackend` with
no mesh (a test-local subclass whose ``context`` is a null context)
driven by the reference's `LockstepScheduler`.  Both serve reduced
Qwen1.5-4B (f32) with the same bridged weights at batch 2, capacity 64.
Greedy token streams, steps and backfills must be equal.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as RS
from repro.launch.scheduler import LockstepScheduler as RefScheduler
from repro.models import transformer as RT
from repro.models.layers import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.launch import serve as TS
from repro_torch.params import params_from_numpy

BATCH, CAPACITY = 2, 64


class _MeshFreeLMBackend(RS.LMBackend):
    """The reference backend, run with no mesh."""

    def context(self):
        return contextlib.nullcontext()


@pytest.fixture(scope="module")
def setup():
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
    ref_params = jax.tree.map(jnp.asarray, np_params)
    srv = TS.Server(cfg, batch=BATCH, capacity=CAPACITY, device="cpu",
                    params=params_from_numpy(np_params, device="cpu"))
    return cfg_ref, ref_params, srv


def _traffic(cfg, seed=0, n=4):
    """Prompts of 18-30 tokens, max_new 3-9: the first run admits two,
    retires one early and backfills."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab, int(rng.integers(18, 31)),
                             dtype=np.int32), int(rng.integers(3, 10)))
            for i in range(n)]


def _ref_serve(cfg_ref, ref_params, traffic, eos_id=None):
    be = _MeshFreeLMBackend(cfg_ref, ref_params, None, capacity=CAPACITY,
                            eos_id=eos_id)
    reqs = [RS.Request(rid=r, prompt=p, max_new=m) for r, p, m in traffic]
    stats = RefScheduler(be, batch=BATCH).serve(reqs)
    return reqs, stats


def _port_serve(srv, traffic):
    reqs = [TS.Request(rid=r, prompt=p, max_new=m) for r, p, m in traffic]
    return reqs, srv.serve(reqs)


@pytest.mark.parametrize("eos", [False, True])
def test_streams_steps_and_backfills_equal_the_reference(setup, eos):
    """Greedy streams equal, with equal decode steps and backfills; with an
    ``eos_id`` taken from the stream, requests retire on it early and the
    freed slots backfill."""
    cfg_ref, ref_params, srv = setup
    traffic = _traffic(cfg_ref)
    eos_id = None
    if eos:
        probe, _ = _port_serve(srv, traffic)
        eos_id = probe[0].out[1]
    ref, ref_stats = _ref_serve(cfg_ref, ref_params, traffic, eos_id)
    srv.backend.eos_id = eos_id
    try:
        got, stats = _port_serve(srv, traffic)
    finally:
        srv.backend.eos_id = None
    assert [r.out for r in got] == [r.out for r in ref]
    assert [s["decode_steps"] for s in stats] == \
        [s["steps"] for s in ref_stats]
    assert [s["backfills"] for s in stats] == \
        [s["backfills"] for s in ref_stats]
    assert sum(s["backfills"] for s in stats) >= 1
    assert all(r.outcome.status == "delivered" for r in got)
    if eos:
        assert any(len(r.out) < m for r, (_, _, m) in zip(got, traffic))
        assert all(r.out[-1] == eos_id or len(r.out) == m
                   for r, (_, _, m) in zip(got, traffic))
    else:
        assert [len(r.out) for r in got] == [m for _, _, m in traffic]


def test_validate_request_refusals_equal_the_reference(setup):
    cfg_ref, ref_params, srv = setup
    ref_be = _MeshFreeLMBackend(cfg_ref, ref_params, None, capacity=CAPACITY)
    good = np.arange(5, dtype=np.int32)
    bad = [
        dict(prompt=[1, 2, 3], max_new=2),
        dict(prompt=np.zeros((2, 3), np.int32), max_new=2),
        dict(prompt=np.zeros(3, np.float32), max_new=2),
        dict(prompt=np.zeros(0, np.int32), max_new=2),
        dict(prompt=good, max_new=0),
        dict(prompt=np.zeros(60, np.int32), max_new=2),
    ]
    for i, kw in enumerate(bad):
        want = ref_be.validate_request(RS.Request(rid=i, **kw))
        assert want is not None
        assert srv.backend.validate_request(TS.Request(rid=i, **kw)) == want
    reqs = [TS.Request(rid=i, **kw) for i, kw in enumerate(bad)]
    reqs.append(TS.Request(rid=99, prompt=good, max_new=2))
    srv.serve(reqs)
    assert [r.outcome.status for r in reqs] == ["refused"] * 6 + \
        ["delivered"]
    assert reqs[-1].out and len(reqs[-1].out) == 2


def _sreqs(cfg, specs, seed=11):
    rng = np.random.default_rng(seed)
    return [TS.Request(rid=100 + i,
                       prompt=rng.integers(0, cfg.vocab, 6, dtype=np.int32),
                       max_new=mn, temperature=t, top_k=k)
            for i, (mn, t, k) in enumerate(specs)]


def test_greedy_lane_is_bit_exact_beside_a_sampling_neighbour(setup):
    _, _, srv = setup
    cfg = srv.cfg
    alone = _sreqs(cfg, [(6, 0.0, 0)])
    srv.serve(alone)
    mixed = _sreqs(cfg, [(6, 0.0, 3), (6, 5.0, 0)])
    srv.serve(mixed)
    assert mixed[0].out == alone[0].out


def test_top_k_one_matches_greedy(setup):
    _, _, srv = setup
    ref = _sreqs(srv.cfg, [(6, 0.0, 0)])
    srv.serve(ref)
    got = _sreqs(srv.cfg, [(6, 1.5, 1)])
    srv.serve(got)
    assert got[0].out == ref[0].out


def test_sampled_streams_are_reproducible_per_seed_and_rid(setup):
    """A sampled stream is keyed by (seed, rid, emission count): the same
    request re-served, alone or beside another, emits the same tokens; a
    hot temperature leaves the greedy path; another rid draws another
    stream."""
    _, _, srv = setup
    cfg = srv.cfg
    a = _sreqs(cfg, [(8, 5.0, 0)])
    srv.serve(a)
    b = _sreqs(cfg, [(8, 5.0, 0), (3, 0.0, 0)])
    srv.serve(b)
    assert a[0].out == b[0].out
    greedy = _sreqs(cfg, [(8, 0.0, 0)])
    srv.serve(greedy)
    assert a[0].out != greedy[0].out
    other = _sreqs(cfg, [(8, 5.0, 0)])
    other[0].rid = 7
    srv.serve(other)
    assert other[0].out != a[0].out
    assert all(0 <= t < cfg.padded_vocab for t in a[0].out + other[0].out)


def test_sample_tokens_keeps_greedy_lanes_and_top_k():
    """`_sample_tokens` on fixed logits: a temperature-0 lane is the argmax;
    top_k=2 draws only among the two largest."""
    from repro_torch.core import threefry
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0],
                           [5.0, 0.0, 4.9, -1.0]])
    temps = torch.tensor([0.0, 50.0])
    for seed in range(20):
        keys = torch.tensor([threefry.prng_key(seed),
                             threefry.fold_in(threefry.prng_key(seed), 1)])
        toks = TS._sample_tokens(logits, temps, torch.tensor([0, 2]), keys)
        assert toks[0] == 1
        assert toks[1] in (0, 2)
