"""The port's `Server` on the seven new LM archs against the reference's
serving, on the CPU.

Each reduced arch (f32, the weights of `tests/test_torch_lm_archs.py`)
is served by the port's `Server` beside the reference's `LMBackend` with
no mesh (a test-local subclass whose ``context`` is a null context;
the reference's own `Server` fails on this tree's jax) behind the
reference's `LockstepScheduler`: greedy streams, decode steps and
backfills equal, the recurrent and windowed archs' backfills at the
exact context length.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_lm_params import seeded_params
from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.launch import serve as RS
from repro.launch.scheduler import LockstepScheduler as RefScheduler
from repro_torch.configs import get_config
from repro_torch.launch import serve as TS
from repro_torch.params import params_from_numpy

NEW_ARCHS = ["phi3-medium-14b", "gemma3-12b", "nemotron-4-340b",
             "granite-moe-3b-a800m", "kimi-k2-1t-a32b", "rwkv6-3b",
             "jamba-v0.1-52b"]


@functools.lru_cache(maxsize=None)
def _arch(name: str):
    cfg_ref = ref_get_config(name).reduce()
    cfg = get_config(name).reduce()
    np_params = seeded_params(cfg_ref)
    return (cfg_ref, cfg, jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


class _MeshFreeLMBackend(RS.LMBackend):
    """The reference backend, run with no mesh."""

    def context(self):
        return contextlib.nullcontext()


SERVE_BATCH, SERVE_CAPACITY = 2, 64


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_greedy_streams_equal_the_reference(name):
    """The port's `Server` against the reference's `LMBackend` (no mesh)
    behind its `LockstepScheduler`, same bridged weights, batch 2: four
    requests (prompts of 18-30 tokens, max_new 3-9), so slots retire and
    backfill.  Streams, decode steps and backfills equal.  Recurrent and
    windowed archs backfill at the exact context length (bucket 1), plain
    attention archs on the 16-token ladder, as the reference does."""
    cfg_ref, cfg, ref_params, port_params = _arch(name)
    rng = np.random.default_rng(0)
    traffic = [(i, rng.integers(0, cfg.vocab, int(rng.integers(18, 31)),
                                dtype=np.int32), int(rng.integers(3, 10)))
               for i in range(4)]
    be = _MeshFreeLMBackend(cfg_ref, ref_params, None,
                            capacity=SERVE_CAPACITY)
    ref = [RS.Request(rid=r, prompt=p, max_new=m) for r, p, m in traffic]
    ref_stats = RefScheduler(be, batch=SERVE_BATCH).serve(ref)
    srv = TS.Server(cfg, batch=SERVE_BATCH, capacity=SERVE_CAPACITY,
                    device="cpu", params=port_params)
    got = [TS.Request(rid=r, prompt=p, max_new=m) for r, p, m in traffic]
    stats = srv.serve(got)
    assert [r.out for r in got] == [r.out for r in ref]
    assert [len(r.out) for r in got] == [m for _, _, m in traffic]
    assert [s["decode_steps"] for s in stats] == \
        [s["steps"] for s in ref_stats]
    assert [s["backfills"] for s in stats] == \
        [s["backfills"] for s in ref_stats]
    assert sum(s["backfills"] for s in stats) >= 1
    assert srv.backend.backfill_bucket == be.backfill_bucket
    exact = any(sp.mixer in ("mamba", "rwkv_tm") or sp.window
                for seg in cfg.segments for sp in seg.layers)
    assert srv.backend.backfill_bucket == (1 if exact else 16)
