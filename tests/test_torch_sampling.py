"""The port's sampling against the JAX reference's threefry draws.

`repro_torch.core.threefry` is held against the installed jax in its
partitionable threefry mode (asserted first, so a change of mode names
itself): keys (`PRNGKey`, `fold_in`) and `random_bits` equal, uniform
draws bit-equal, and Gumbel noise within an ulp at each of its two
logarithms (the two sides' `log`s may round differently; composed, the
noise is within 2 ulps of max(|g|, 1)).  `_sample_tokens` then emits the
reference's tokens for the same logits and keys over several seeds,
temperatures and top-ks, and served sampled streams (reduced Qwen1.5-4B
and RWKV-6-3B, f32, the same bridged weights) equal the reference's
`LMBackend` run with no mesh, keyed by the same (seed, rid, count).
"""
import contextlib

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
from repro_torch.configs import get_config
from repro_torch.core import threefry
from repro_torch.launch import serve as TS
from repro_torch.params import params_from_numpy

TINY = float(np.finfo(np.float32).tiny)


def test_the_reference_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def _keys(seed, data):
    """The reference's and the port's fold_in(PRNGKey(seed), data...)."""
    ref, port = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    for d in data:
        ref, port = jax.random.fold_in(ref, d), threefry.fold_in(port, d)
    return ref, port


KEY_CASES = [(0, ()), (0, (0,)), (3, (7, 0)), (12345, (2**31 - 1, 5)),
             (-1, (99,)), (2**32 + 5, (1, 2, 3)), (7, (42, 1 << 20))]


@pytest.mark.parametrize("seed,data", KEY_CASES)
def test_keys_and_bits_equal_the_reference(seed, data):
    ref, port = _keys(seed, data)
    assert tuple(int(v) for v in np.asarray(jax.random.key_data(ref))) == \
        port
    for n in (1, 7, 4096):
        want = np.asarray(jax.random.bits(ref, (n,))).astype(np.int64)
        got = threefry.random_bits(torch.tensor([port]), n)[0].numpy()
        np.testing.assert_array_equal(got, want)


def test_the_block_function_on_python_ints_and_tensors_agree():
    k1, k2 = 0x12345678, 0x9ABCDEF0
    x1 = torch.tensor([0, 1, 2**32 - 1], dtype=torch.int64)
    x2 = torch.tensor([5, 2**31, 77], dtype=torch.int64)
    y1, y2 = threefry.threefry2x32(k1, k2, x1, x2)
    for i in range(3):
        assert threefry.threefry2x32(k1, k2, int(x1[i]), int(x2[i])) == \
            (int(y1[i]), int(y2[i]))
    assert int(y1.max()) <= threefry.MASK and int(y1.min()) >= 0


@pytest.mark.parametrize("seed", range(4))
def test_uniform_is_bit_equal_and_gumbel_within_an_ulp(seed):
    ref_keys, keys = zip(*(_keys(seed, (rid, c)) for rid in (0, 9)
                           for c in range(3)))
    n = 65536
    keys_t = torch.tensor(keys)
    bits = threefry.random_bits(keys_t, n)
    u = threefry.uniform(bits, TINY)
    g = threefry.gumbel(keys_t, n)
    for i, rk in enumerate(ref_keys):
        want_u = np.asarray(jax.random.uniform(rk, (n,), minval=TINY))
        np.testing.assert_array_equal(u[i].numpy().view(np.uint32),
                                      want_u.view(np.uint32))
        want_g = np.asarray(jax.random.gumbel(rk, (n,)))
        # each logarithm within an ulp of the reference's on the same input
        inner = -torch.log(u[i])
        ref_inner = np.asarray(-jnp.log(jnp.asarray(u[i].numpy())))
        assert _ulps(inner.numpy(), ref_inner) <= 1
        ref_outer = np.asarray(-jnp.log(jnp.asarray(inner.numpy())))
        assert _ulps(g[i].numpy(), ref_outer) <= 1
        # composed: within 2 ulps of max(|g|, 1)
        spacing = np.spacing(np.maximum(np.abs(want_g), 1).astype(np.float32))
        assert float((np.abs(g[i].numpy() - want_g) / spacing).max()) <= 2


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("seed", range(6))
def test_sample_tokens_equal_the_reference(seed):
    """Same logits, temperatures, top-ks and keys: the same tokens, greedy
    lanes included, over 16 draws per lane."""
    rng = np.random.default_rng(seed)
    b, v = 6, 512
    temps = np.array([0.0, 0.8, 1.0, 5.0, 0.3, 1.5], np.float32)
    topks = np.array([0, 40, 0, 1, 3, 0], np.int32)
    for count in range(16):
        logits = (3 * rng.standard_normal((b, v))).astype(np.float32)
        ref_keys, keys = zip(*(_keys(seed, (rid & 0x7FFFFFFF, count))
                               for rid in range(100, 100 + b)))
        want = np.asarray(RS._sample_tokens(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topks),
            jnp.stack(ref_keys)))
        got = TS._sample_tokens(torch.from_numpy(logits),
                                torch.from_numpy(temps),
                                torch.from_numpy(topks).long(),
                                torch.tensor(keys)).numpy()
        np.testing.assert_array_equal(got, want)


class _MeshFreeLMBackend(RS.LMBackend):
    """The reference backend, run with no mesh."""

    def context(self):
        return contextlib.nullcontext()


BATCH, CAPACITY = 2, 64


@pytest.mark.parametrize("name", ["qwen1.5-4b", "rwkv6-3b"])
def test_served_sampled_streams_equal_the_reference(name):
    """Sampled and greedy requests side by side (temperature 0.8 / top-k
    40, temperature 1.5 / no top-k, greedy), four requests at batch 2 so
    slots retire and backfill: every stream the reference's, and the same
    again when the port serves them a second time."""
    cfg_ref = ref_get_config(name).reduce()
    cfg = get_config(name).reduce()
    np_params = seeded_params(cfg_ref)
    rng = np.random.default_rng(3)
    specs = [(0.8, 40, 9), (0.0, 0, 4), (1.5, 0, 7), (0.8, 40, 6)]
    traffic = [(200 + i, rng.integers(0, cfg.vocab, int(rng.integers(
        10, 30)), dtype=np.int32), m, t, k)
        for i, (t, k, m) in enumerate(specs)]
    be = _MeshFreeLMBackend(cfg_ref, jax.tree.map(jnp.asarray, np_params),
                            None, capacity=CAPACITY, sample_seed=5)
    ref = [RS.Request(rid=r, prompt=p, max_new=m, temperature=t, top_k=k)
           for r, p, m, t, k in traffic]
    ref_stats = RefScheduler(be, batch=BATCH).serve(ref)
    srv = TS.Server(cfg, batch=BATCH, capacity=CAPACITY, device="cpu",
                    params=params_from_numpy(np_params, device="cpu"))
    srv.backend.sample_seed = 5
    for _ in range(2):
        got = [TS.Request(rid=r, prompt=p, max_new=m, temperature=t, top_k=k)
               for r, p, m, t, k in traffic]
        stats = srv.serve(got)
        assert [r.out for r in got] == [r.out for r in ref]
    assert sum(s["backfills"] for s in stats) == \
        sum(s["backfills"] for s in ref_stats) >= 1
    greedy = [r.out for r in got if r.temperature == 0]
    assert greedy and all(len(o) == 4 for o in greedy)
