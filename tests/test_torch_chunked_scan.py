"""Chunked remat in the recurrent scans (`models.layers.chunked_remat_scan`,
the reference's ``layers.py:231``): RWKV-6's time mix and Mamba's
selective scan, on the CPU.

- The chunk is the largest divisor of T at most ``cfg.scan_chunk``.
- Values and gradients do not depend on the chunk, bit for bit: a toy
  recurrence (several chunk sizes), a Mamba scan at Jamba's full width
  in bf16 at batch 1, and one training step of reduced RWKV-6 and Jamba
  (T 32, batch 4) with ``scan_chunk`` 8 (four chunks) and 32 (one).
  Prefill, with no gradient, takes the plain loop: bits unchanged.  (The reduced archs' steps against the reference's
  `build_train` at 1e-5 are `test_torch_train_step.py`'s, whose T 32
  now runs chunked.)
- On meta the dry run counts the chunked loop as T trips: nested
  `utils.cost.scan`s (over the chunks in the Function's forward, and
  within each chunk's recompute) count the same FLOPs, bytes and ops as
  every trip run, for RWKV-6 at T 64 in 8 chunks of 8.
- The peak falls as the arithmetic says.  A plain loop under autograd
  (the layer group's remat alone, the form before the chunks) keeps
  every trip's saved tensors in the group's recompute (T of them for
  each recurrent layer of the group); the chunked one keeps T / c
  carries a layer plus one chunk's c trips of one layer: a fall of
  layers x (T x trip - (T / c) x carry) - c x trip bytes, a trip's bytes
  measured by autograd's saved-tensor hooks (two trips less one).
  Reduced, batch 2, T 32, c 4, meta ``temp_bytes`` (the plain loop
  counted every trip: `scan`'s standing-in trip overstates Jamba's):
  RWKV-6 (1 layer a group; 393,216 bytes and a 131,072 carry a trip)
  17,598,992 -> 8,286,480, a fall of 9,312,512 against a predicted
  9,961,472 (6.5% under); Jamba (7 Mamba layers a group; 67,584 and
  32,768) 33,984,224 -> 20,451,040, a fall of 13,533,184 against
  13,033,472 (3.8% over).  Held within 10% of the prediction.
"""
import dataclasses
from unittest import mock

import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import LMBatchSpec, SyntheticLM
from repro_torch.launch import step_builders as sb
from repro_torch.models import mamba as TM
from repro_torch.models import rwkv as TR
from repro_torch.models import transformer as TT
from repro_torch.models.layers import (chunked_remat_scan, init_params,
                                       scan_chunk_size)
from repro_torch.utils import cost as C
from repro_torch.utils.tree import leaves

FALL_RTOL = 0.10


@pytest.mark.parametrize("t,chunk,want", [
    (9, 8, 3), (32, 8, 8), (2048, 256, 256), (7, 4, 1), (5, 256, 5),
    (4096, 256, 256), (30, 8, 6)])
def test_chunk_is_the_largest_divisor_at_most_scan_chunk(t, chunk, want):
    assert scan_chunk_size(t, chunk) == want


def _toy(chunk: int, t: int = 12):
    x = torch.linspace(-1, 1, t * 12).reshape(3, t, 4).requires_grad_()
    w = torch.linspace(0.5, 1.5, 4, requires_grad=True)

    def step(c, xi, sh):
        c = torch.tanh(c * sh[0] + xi[0])
        return c, c * xi[0]

    carry, y = chunked_remat_scan(step, torch.zeros(3, 4), t, (x,),
                                  (w * 1.0,), chunk=chunk)
    (y.square().sum() + carry.sum()).backward()
    return carry, y, x.grad, w.grad


@pytest.mark.parametrize("chunk", [1, 3, 4, 5, 12])
def test_values_and_gradients_do_not_depend_on_the_chunk(chunk):
    want = _toy(12)
    for a, b in zip(_toy(chunk), want):
        assert torch.equal(a, b)


def test_full_width_mamba_scan_at_batch_one_does_not_depend_on_the_chunk():
    """Jamba's d_inner 8192 in bf16, batch 1, T 64 in 4 chunks or 1:
    the shapes at which a carry's gradient takes another layout than at
    the reduced ones."""
    d, n, t = 2 * get_config("jamba-v0.1-52b").d_model, TM.D_STATE, 64
    gen = torch.Generator().manual_seed(1)
    base = [torch.randn(1, t, d, generator=gen).to(torch.bfloat16),
            torch.rand(1, t, d, generator=gen) * 0.1,
            torch.randn(1, t, n, generator=gen),
            torch.randn(1, t, n, generator=gen),
            torch.randn(d, n, generator=gen)]
    out = []
    for chunk in (16, 64):
        xc, dt, b, c, a_log = [x.clone().requires_grad_() for x in base]
        h, y = chunked_remat_scan(
            lambda h, xi, sh: TM._scan_step(*sh, h, *xi),
            torch.zeros(1, d, n), t, (xc, dt, b, c), (-torch.exp(a_log),),
            chunk=chunk)
        y.square().sum().backward()
        out.append([y, xc.grad, dt.grad, b.grad, c.grad, a_log.grad])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def _steps(arch: str, chunk: int, kind: str, t: int = 32):
    cfg = dataclasses.replace(get_config(arch).reduce(), scan_chunk=chunk)
    params = init_params(TT.lm_schema(cfg), 1, device="cpu")
    data = SyntheticLM(LMBatchSpec(global_batch=4, seq_len=t,
                                   vocab=cfg.vocab), seed=0)
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(100).items()}
    if kind == "prefill":
        with torch.no_grad():
            logits, _ = TT.prefill(params, {"tokens": batch["tokens"]}, cfg,
                                   capacity=t)
        return [logits]
    state = sb.make_optimizer(cfg).init(params)
    step = sb.build_train(cfg, ShapeSpec("t", t, 4, "train"))
    params, state, m = step(params, state, batch, 100)
    return [torch.tensor([float(m[k]) for k in sorted(m)])] + \
        leaves(params) + leaves(state)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_chunked_steps_are_bit_equal_to_one_chunk(arch, kind):
    chunked, plain = _steps(arch, 8, kind), _steps(arch, 32, kind)
    assert len(chunked) == len(plain)
    for a, b in zip(chunked, plain):
        assert torch.equal(a, b)


def _plain_scan(step, carry, t, x):
    ys = []
    for i in range(t):
        carry, y = step(carry, i)
        ys.append(y)
    return carry, ys


def test_meta_counts_the_chunked_loop_as_every_trip():
    cfg = get_config("rwkv6-3b").reduce()          # scan_chunk 8
    step = sb.build(cfg, ShapeSpec("p", 64, 2, "train"))
    _, once = C.count(step.fn, *step.args)
    with mock.patch.object(TR, "scan", _plain_scan):
        _, unrolled = C.count(step.fn, *step.args)
    assert (once.flops, once.bytes) == (unrolled.flops, unrolled.bytes)
    assert once.ops == unrolled.ops
    one = dataclasses.replace(cfg, scan_chunk=64)
    step = sb.build(one, ShapeSpec("p", 64, 2, "train"))
    _, whole = C.count(step.fn, *step.args)
    # one chunk or eight, each trip runs twice forward and once backward
    assert once.flops == whole.flops
    assert once.peak_bytes < whole.peak_bytes


def _plain_remat_scan(step, carry, t, xs, shared=(), *, chunk, loop):
    """The loop under autograd with no chunk of its own, every trip run:
    the layer group's remat alone (the form before the chunks)."""
    carry, ys = _plain_scan(
        lambda s, i: step(s, tuple(x[:, i] for x in xs), shared), carry, t,
        xs[0])
    return carry, torch.stack(ys, dim=1)


def _saved_bytes(run, own) -> int:
    """Bytes of the storages that autograd saves in ``run()`` besides
    the tensors ``own``."""
    saved = []     # held, so that no storage's address is reused
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        run()
    own = {StorageWeakRef(a.untyped_storage()).cdata for a in own}
    keys = {StorageWeakRef(t.untyped_storage()).cdata:
            t.untyped_storage().nbytes() for t in saved}
    return sum(n for k, n in keys.items() if k not in own)


def _meta(*shape):
    return torch.empty(*shape, device="meta", requires_grad=True)


def _trip(arch: str, b: int) -> tuple[int, int, int]:
    """(recurrent layers in a layer group, bytes autograd keeps a trip,
    carry bytes).  A trip's bytes are those two trips save less those
    one saves (so a carry that one trip saves as its output and the
    next as its input counts once)."""
    cfg = get_config(arch).reduce()
    layers = sum(sp.mixer in ("rwkv_tm", "mamba")
                 for sp in cfg.segments[0].layers)
    if arch.startswith("rwkv"):
        h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
        s = _meta(b, h, hd, hd)
        args = [_meta(b, h, hd) for _ in range(4)] + [_meta(h, hd)]

        def trips(n):
            c = s
            for _ in range(n):
                c, _ = TR._tm_step(c, *args)
    else:
        d_in = 2 * cfg.d_model
        s = _meta(b, d_in, TM.D_STATE)
        args = [_meta(d_in, TM.D_STATE), _meta(b, d_in), _meta(b, d_in),
                _meta(b, TM.D_STATE), _meta(b, TM.D_STATE)]

        def trips(n):
            c = s
            for _ in range(n):
                c, _ = TM._scan_step(args[0], c, *args[1:])
    own = [s, *args]
    one = _saved_bytes(lambda: trips(1), own)
    return layers, _saved_bytes(lambda: trips(2), own) - one, \
        s.numel() * 4


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_meta_peak_falls_as_the_arithmetic_says(arch):
    b, t, c = 2, 32, 4
    cfg = get_config(arch).reduce()
    step = sb.build(dataclasses.replace(cfg, scan_chunk=c),
                    ShapeSpec("p", t, b, "train"))
    chunked = C.count(step.fn, *step.args)[1].temp_bytes
    step = sb.build(cfg, ShapeSpec("p", t, b, "train"))
    with mock.patch.object(TR, "chunked_remat_scan", _plain_remat_scan), \
            mock.patch.object(TM, "chunked_remat_scan", _plain_remat_scan):
        plain = C.count(step.fn, *step.args)[1].temp_bytes
    layers, trip, carry = _trip(arch, b)
    predicted = layers * (t * trip - (t // c) * carry) - c * trip
    fall = plain - chunked
    assert abs(fall / predicted - 1) <= FALL_RTOL, (
        f"{arch}: temp {plain} -> {chunked} bytes, a fall of {fall} "
        f"against {predicted} ({layers} layers, {trip} bytes and a "
        f"{carry} carry a trip)")
