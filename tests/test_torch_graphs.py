"""The port's jit layer: CUDA graphs per CNN shape bucket and per LM decode
(width, capacity), and what makes them capturable.

On the CPU (JAX reference beside the port, reduced sizes):
- decode at a 0-d tensor position against the reference's decode step,
  through a plain cache, a circular one (positions past the capacity) and
  a windowed layer: logits and caches within 1e-5 relative (f32 weights;
  the port's einsums sum in another order than XLA's);
- prefill into caches the caller owns, filled with junk first: the same
  logits and caches as a fresh prefill, bit for bit (the same ops; every
  slot is overwritten);
- `BatchedApply` counts the reference's cache keys over the pow2 wave
  ladder and two image buckets, and its logits agree within 1e-5;
- the launch counters under capture and replay, with stub graph objects;
- the CNN backend's batch padding over a reused buffer, and the LM
  backend owning its caches.

Marked ``gpu`` (they skip here: a CUDA graph needs the card; run them
with ``PYTHONPATH=src python -m pytest tests/test_torch_graphs.py -q`` on
a machine with an H100): a served ResNet-18 wave by replay bit-equal to
eager `net_apply` with the same impl, f32 and int8, with exact launch
counts, also when partial waves make two buckets whose graphs share one
memory pool and replay out of their capture order; one replayed decode
step bit-equal to eager `decode_step` from the same caches and position
(bf16); a capture that waits on the host raises (in a process of its
own).
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.configs import get_config as ref_get_config
from repro.models import graph as RG
from repro.models import transformer as RT
from repro.models.layers import init_params as ref_init_params
from repro_torch.configs import base as TB
from repro_torch.configs import get_config
from repro_torch.kernels import capture as TC
from repro_torch.kernels.vsconv import vsconv_halo_kernel
from repro_torch.kernels.vsmm import vsmm_kernel
from repro_torch.launch import serve as TS
from repro_torch.models import graph as TG
from repro_torch.models import transformer as TT
from repro_torch.params import params_from_numpy

RTOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- decode at a tensor position --------------------------------------------

# case -> (windowed second layer?, capacity, prompt length, decode steps)
DECODE_CASES = {
    "plain": (False, 40, 24, 6),
    "circular": (False, 16, 12, 8),     # positions 12..19 pass capacity 16
    "window": (True, 40, 12, 8),        # window 8: a circular 8-slot cache
}


def _lm_cfgs(windowed: bool):
    cfg_ref = ref_get_config("qwen1.5-4b").reduce()
    cfg = get_config("qwen1.5-4b").reduce()
    if windowed:
        cfg_ref = dataclasses.replace(cfg_ref, segments=(RB.Segment(1, (
            RB.LayerSpec("attn", "mlp"),
            RB.LayerSpec("attn", "mlp", window=8))),))
        cfg = dataclasses.replace(cfg, segments=(TB.Segment(1, (
            TB.LayerSpec("attn", "mlp"),
            TB.LayerSpec("attn", "mlp", window=8))),))
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


def _leaves(caches):
    return [c for seg in caches for layer in seg.values()
            for c in layer["mix"].values()]


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_at_a_tensor_position_matches_the_reference(case):
    windowed, cap, t, steps = DECODE_CASES[case]
    cfg_ref, cfg, ref_params, port_params = _lm_cfgs(windowed)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (2, t))
    _, ref_caches = RT.prefill(ref_params,
                               {"tokens": jnp.asarray(toks, jnp.int32)},
                               cfg_ref, capacity=cap)
    _, caches = TT.prefill(port_params, {"tokens": torch.from_numpy(toks)},
                           cfg, capacity=cap)
    if windowed:
        assert _leaves(caches)[2].shape[2] == 8   # the windowed layer's
    for step in range(steps):
        nxt = rng.integers(0, cfg.vocab, (2, 1))
        ref_logits, ref_caches = RT.decode_step(
            ref_params, ref_caches, jnp.asarray(nxt, jnp.int32),
            jnp.int32(t + step), cfg_ref)
        logits, caches = TT.decode_step(
            port_params, caches, torch.from_numpy(nxt),
            torch.tensor(t + step, dtype=torch.int64), cfg)
        assert _rel(logits, ref_logits) <= RTOL, step
    ref_leaves = jax.tree.leaves(ref_caches)
    for got, ref in zip(_leaves(caches), ref_leaves):
        assert tuple(got.shape) == ref.shape
        assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_prefill_into_owned_caches_equals_a_fresh_prefill(case):
    windowed, cap, t, _ = DECODE_CASES[case]
    _, cfg, _, params = _lm_cfgs(windowed)
    toks = {"tokens": torch.from_numpy(
        np.random.default_rng(8).integers(0, cfg.vocab, (2, t)))}
    owned = TT.init_cache(cfg, 2, cap, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    for leaf in _leaves(owned):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))  # junk
    logits, caches = TT.prefill(params, toks, cfg, capacity=cap,
                                caches=owned)
    fresh_logits, fresh = TT.prefill(params, toks, cfg, capacity=cap)
    assert all(a is b for a, b in zip(_leaves(caches), _leaves(owned)))
    assert torch.equal(logits, fresh_logits)
    for got, ref in zip(_leaves(caches), _leaves(fresh)):
        assert torch.equal(got, ref)


def test_the_lm_backend_prefills_into_its_own_caches():
    _, cfg, _, params = _lm_cfgs(False)
    srv = TS.Server(cfg, batch=2, capacity=40, device="cpu", params=params)
    rng = np.random.default_rng(9)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab, 10 + i),
                       max_new=3) for i in range(3)]
    seen = []
    prefill = TT.prefill

    def spy(*args, **kw):
        seen.append(kw.get("caches"))
        return prefill(*args, **kw)

    with mock.patch.object(TT, "prefill", spy):
        srv.serve(reqs)
    owned = srv.backend.caches[2]
    assert seen[0] is owned and seen[1:] == [None] * (len(seen) - 1)
    assert srv.backend.graphs == {}      # the CPU decodes eagerly
    assert all(len(r.out) == 3 for r in reqs)


# -- BatchedApply's buckets ---------------------------------------------------

def _tiny_nets():
    layers = lambda M: (M.Conv("c1", 3, 8, 3, 3, 1), M.Pool("gap"),  # noqa
                        M.Flatten(), M.Classifier("fc", 8, 10))
    ref_net = RG.SparseNet("tiny", layers(RG))
    net = TG.SparseNet("tiny", layers(TG))
    rng = np.random.default_rng(10)
    params = {name: {k: (0.2 * rng.standard_normal(p.shape)).astype(
        np.float32) for k, p in entry.items()}
        for name, entry in net.schema().items()}
    return (ref_net, jax.tree.map(jnp.asarray, params), net,
            params_from_numpy(params, device="cpu"))


def test_batched_apply_counts_the_reference_cache_keys():
    """Waves of 1..8 occupied slots shrink to the pow2 ladder (1, 2, 4, 8),
    at two image buckets: 8 keys on both sides, none added by repeats."""
    ref_net, ref_params, net, params = _tiny_nets()
    ref = RG.BatchedApply(ref_net, ref_params, impl="jnp")
    port = TG.BatchedApply(net, params, impl="plain")
    rng = np.random.default_rng(11)
    for _ in range(2):
        for size in (8, 16):
            for occ in range(1, 9):
                nb = min(8, 1 << max(occ - 1, 0).bit_length())
                x = rng.standard_normal((nb, size, size, 3)).astype(
                    np.float32)
                y_ref = ref(jnp.asarray(x))
                y = port(x.shape, lambda out, x=x: np.copyto(out, x))
                assert _rel(y, y_ref) <= RTOL
    assert port.compiles == ref.compiles == 8
    assert port.replays == 0
    assert all(v is None for v in port.buckets.values())


# -- launch counters under capture and replay ---------------------------------

class _StubGraph:
    def __init__(self):
        self.replayed = 0

    def replay(self):
        self.replayed += 1


class _StubStream:
    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _stub_cuda():
    """`capture`'s CUDA calls, stubbed: the streams do nothing, the graph
    context captures nothing and the graph is a `_StubGraph`."""
    with mock.patch.object(torch.cuda, "Stream", _StubStream), \
            mock.patch.object(torch.cuda, "current_stream",
                              lambda: _StubStream()), \
            mock.patch.object(torch.cuda, "stream",
                              lambda s: contextlib.nullcontext()), \
            mock.patch.object(torch.cuda, "CUDAGraph", _StubGraph), \
            mock.patch.object(torch.cuda, "graph",
                              lambda g, pool=None: contextlib.nullcontext()):
        yield


@pytest.fixture
def zeroed_counters():
    saved = TC.counts()
    TC.add_counts({k: -n for k, n in saved.items()})
    yield
    TC.add_counts({k: saved[k] - n for k, n in TC.counts().items()})


def _wave():
    """What one forward's wrappers add: 3 conv launches (one of them the
    stem body), 2 vsmm launches, all int8."""
    vsconv_halo_kernel.launches += 3
    vsconv_halo_kernel.stem_launches += 1
    vsconv_halo_kernel.int8_launches += 3
    vsmm_kernel.launches += 2
    vsmm_kernel.int8_launches += 2
    return "out"


def test_replays_add_the_counts_the_capture_recorded(zeroed_counters):
    with _stub_cuda():
        graph, out = TC.capture(_wave)
    assert out == "out"
    # the warm-up ran and counts; the capture ran nothing and does not
    assert (vsconv_halo_kernel.launches, vsconv_halo_kernel.stem_launches,
            vsmm_kernel.launches, vsmm_kernel.int8_launches) == (3, 1, 2, 2)
    assert graph.launches == {
        (vsconv_halo_kernel, "launches"): 3,
        (vsconv_halo_kernel, "stem_launches"): 1,
        (vsconv_halo_kernel, "int8_launches"): 3,
        (vsmm_kernel, "launches"): 2, (vsmm_kernel, "int8_launches"): 2}
    for _ in range(4):
        graph.replay()
    assert graph.replays == graph.graph.replayed == 4
    assert (vsconv_halo_kernel.launches, vsconv_halo_kernel.stem_launches,
            vsconv_halo_kernel.int8_launches, vsmm_kernel.launches,
            vsmm_kernel.int8_launches) == (15, 5, 15, 10, 10)
    assert sum(TC.counts().values()) == 5 * 11


def test_a_failed_capture_raises_and_counts_only_the_warm_up(
        zeroed_counters):
    calls = []

    def fails_when_captured():
        calls.append(1)
        _wave()
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    with _stub_cuda(), pytest.raises(RuntimeError, match="capturing"):
        TC.capture(fails_when_captured)
    assert (vsconv_halo_kernel.launches, vsmm_kernel.launches) == (3, 2)


# -- the CNN backend's batch padding --------------------------------------------

def test_pad_batch_overwrites_a_reused_buffer():
    rng = np.random.default_rng(12)
    images = [rng.standard_normal(s).astype(np.float32)
              for s in ((16, 16, 3), (9, 16, 3), (16, 5, 3), (1, 1, 3))]
    want = np.zeros((8, 16, 16, 3), np.float32)
    for i, im in enumerate(images):
        want[i, :im.shape[0], :im.shape[1]] = im
    buf = np.full((8, 16, 16, 3), np.nan, np.float32)  # the last wave's
    assert TS._pad_batch(buf, images) is buf
    np.testing.assert_array_equal(buf, want)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph is captured and "
                    "replayed only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [None, "int8"])
def test_served_waves_replay_bit_equal_to_eager(cuda, dtype):
    """ResNet-18 at 224 px, 16 requests at batch 8: one graph, captured
    at the first wave (its warm-up launches count), replayed every wave;
    the logits equal eager `net_apply` with the path's impl bit for bit."""
    srv = TS.CNNServer(get_config("vscnn-resnet18"), batch=8, dtype=dtype,
                       seed=0, device=cuda)
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((224, 224, 3)).astype(np.float32)
              for _ in range(16)]
    counters = (vsconv_halo_kernel, vsmm_kernel)
    before = [k.launches for k in counters]
    reqs = [TS.ImageRequest(rid=i, image=im) for i, im in enumerate(images)]
    srv.serve(reqs)
    apply = srv.backend.apply
    assert (apply.compiles, apply.replays) == (1, 2)
    assert [k.launches - n for k, n in zip(counters, before)] == \
        [17 * 3, 4 * 3]   # 2 waves and the warm-up
    with torch.inference_mode():
        eager = torch.cat([TG.net_apply(
            srv.net, srv.params,
            torch.from_numpy(np.stack(images[i:i + 8])).to(cuda),
            sparse=srv.sparse, impl=apply.impl) for i in (0, 8)]).cpu()
    served = np.stack([r.logits for r in reqs])
    np.testing.assert_array_equal(served, eager.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [None, "int8"])
def test_partial_waves_replay_bit_equal_across_buckets(cuda, dtype):
    """ResNet-18 at 224 px, batch 8: 4 requests capture the bucket of 4
    first, then 12 requests twice capture the bucket of 8 and replay 8, 4,
    8, 4.  The two graphs share the instance's memory pool; every wave's
    logits equal eager `net_apply` on the same batch bit for bit, and the
    launch counts are exact: 2 warm-ups and 5 replays."""
    srv = TS.CNNServer(get_config("vscnn-resnet18"), batch=8, dtype=dtype,
                       seed=0, device=cuda)
    rng = np.random.default_rng(2)
    images = [rng.standard_normal((224, 224, 3)).astype(np.float32)
              for _ in range(12)]
    apply = srv.backend.apply
    with torch.inference_mode():
        eager = {n: TG.net_apply(
            srv.net, srv.params,
            torch.from_numpy(np.stack(images[i:i + n])).to(cuda),
            sparse=srv.sparse, impl=apply.impl).cpu().numpy()
            for i, n in ((0, 8), (8, 4))}
    counters = (vsconv_halo_kernel, vsmm_kernel)
    before = [k.launches for k in counters]
    served = []
    for batch in (images[8:], images, images):
        reqs = [TS.ImageRequest(rid=i, image=im)
                for i, im in enumerate(batch)]
        srv.serve(reqs)
        served.append(np.stack([r.logits for r in reqs]))
    np.testing.assert_array_equal(served[0], eager[4])
    for y in served[1:]:
        np.testing.assert_array_equal(y[:8], eager[8])
        np.testing.assert_array_equal(y[8:], eager[4])
    assert (apply.compiles, apply.replays) == (2, 5)
    assert [k.launches - n for k, n in zip(counters, before)] == \
        [17 * 7, 4 * 7]   # 2 warm-ups and 5 replays


@pytest.mark.gpu
def test_a_replayed_decode_step_is_bit_equal_to_eager(cuda):
    """Reduced Qwen1.5-4B in bf16 at batch 2: served greedy tokens equal a
    direct eager loop, and one more replay's logits and caches equal an
    eager `decode_step` from copies of the same caches and position."""
    cfg = dataclasses.replace(get_config("qwen1.5-4b").reduce(),
                              param_dtype="bfloat16",
                              cache_dtype_str="bfloat16")
    srv = TS.Server(cfg, batch=2, capacity=64, seed=0, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 32) for _ in range(2)]  # no pad
    reqs = [TS.Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    srv.serve(reqs)
    be = srv.backend
    (g,) = be.graphs.values()
    assert g.graph.replays == 5
    toks = torch.from_numpy(np.stack(prompts)).to(cuda)
    logits, caches = TT.prefill(srv.params, {"tokens": toks}, cfg,
                                capacity=64)
    nxt, out = torch.argmax(logits, -1), []
    for i in range(6):
        out.append(nxt)
        logits, caches = TT.decode_step(srv.params, caches, nxt[:, None],
                                        32 + i, cfg)
        nxt = torch.argmax(logits, -1)
    direct = torch.stack(out, 1).cpu().numpy()
    assert [r.out for r in reqs] == direct.tolist()

    live = be.caches[2]
    copy = [{k: {"mix": {n: t.clone() for n, t in v["mix"].items()}}
             for k, v in seg.items()} for seg in live]
    tokens = torch.tensor([[3], [5]], device=cuda)
    g.tokens.copy_(tokens)
    g.pos.fill_(40)
    g.graph.replay()
    eager, copy = TT.decode_step(srv.params, copy, tokens, 40, cfg)
    torch.cuda.synchronize()
    assert torch.equal(g.logits, eager)
    for a, b in zip(_leaves(live), _leaves(copy)):
        assert torch.equal(a, b)


_SYNCING_CAPTURE = r"""
import sys
from unittest import mock

import torch
from repro_torch.configs import get_config
from repro_torch.launch import serve as TS
from repro_torch.models import graph as TG

srv = TS.CNNServer(get_config("vscnn-resnet18").reduce(), batch=2, seed=0,
                   device="cuda")
apply = srv.backend.apply
forward = TG.net_apply


def syncs(*args, **kw):
    y = forward(*args, **kw)
    float(y.sum())   # waits on the host: not capturable
    return y


with mock.patch.object(TG, "net_apply", syncs):
    try:
        apply((2, 32, 32, 3), lambda out: out.fill(0))
    except RuntimeError:
        print("raised", apply.compiles, apply.replays)
        sys.exit(0)
print("no error")
"""


@pytest.mark.gpu
def test_a_capture_that_waits_on_the_host_raises(cuda):
    """A forward that waits on the host cannot be captured: the call
    raises, and nothing was captured or replayed.  It runs in a process of
    its own, since PyTorch leaves a failed capture's CUDA state (the
    default generator's capture mode) behind in the process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _SYNCING_CAPTURE],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[-3:] == ["raised", "0", "0"], proc.stdout
