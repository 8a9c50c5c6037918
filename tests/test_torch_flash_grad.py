"""Gradients through the port's attention and f32-out products.

`kernels.flash.flash_bwd_plain` (the backward of `FlashFwd`, the flash
kernel under autograd) is held to the gradient XLA derives for the
reference's jnp flash (`repro/models/attention.py::flash_attention`,
``jax.vjp``) and to autograd through `flash_fwd_plain`: causal, windowed,
non-causal, a ``q_offset``, several query blocks, GQA through
`repeat_kv`.  f32 within 1e-5 relative of max|grad|; bf16 within 2e-2.
`layers._MatmulF32` (the derivative of an ``mm`` / ``bmm`` with an f32
``out_dtype``, which PyTorch lacks) runs its backward here on a CPU
stand-in for the product: it equals autograd through the f32 product.
Remat recomputes inside ``precision_flow`` (its gradients equal those
without remat under ``bf16_flow``).

Their counterparts on the card are in `test_torch_train_cuda.py` (a file
that imports no JAX).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro_torch.configs import get_config
from repro_torch.data.pipeline import LMBatchSpec, SyntheticLM
from repro_torch.kernels import flash as TF
from repro_torch.launch import step_builders as sb
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.layers import init_params
from repro_torch.models import transformer as TT

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
BF16_TOL = 2e-2

# (B, H, Tq, Tk, hd, causal, window, q_offset)
CASES = [
    (2, 2, 48, 48, 16, True, None, 0),
    (1, 3, 40, 40, 32, True, 9, 0),
    (2, 2, 30, 30, 16, False, None, 0),
    (1, 2, 16, 24, 16, True, None, 8),
    (1, 2, 300, 300, 8, True, None, 0),  # two query blocks of 150
]


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inputs(case, seed=0):
    b, h, tq, tk, hd = case[:5]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, tq, h, hd), (b, tk, h, hd), (b, tk, h, hd), (b, tq, h, hd)))
    return q, k, v, do


def _bh(a):
    """(B, T, H, hd) numpy -> (B*H, T, hd) tensor."""
    t = torch.from_numpy(a)
    b, n, h, hd = t.shape
    return t.transpose(1, 2).reshape(b * h, n, hd).contiguous()


def _unbh(t, b, h):
    bh, n, hd = t.shape
    return t.reshape(b, h, n, hd).transpose(1, 2).numpy()


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_the_reference_derivative(case):
    b, h, tq, tk, hd, causal, window, q_offset = case
    q, k, v, do = _inputs(case)
    f = lambda q_, k_, v_: RA.flash_attention(
        q_, k_, v_, causal=causal, window=window, q_offset=q_offset,
        bq=16, bk=16)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    qt, kt, vt = (_bh(a).requires_grad_() for a in (q, k, v))
    o = TF.FlashFwd.apply(qt, kt, vt, causal, window, q_offset)
    assert _rel(_unbh(o.detach(), b, h), out) <= RTOL
    grads = torch.autograd.grad(o, (qt, kt, vt), _bh(do))
    for name, g, r in zip("qkv", grads, ref):
        assert _rel(_unbh(g, b, h), r) <= RTOL, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES[:4])
def test_function_matches_autograd_through_plain(case, dtype):
    b, h, tq, tk, hd, causal, window, q_offset = case
    dt = getattr(torch, dtype)
    q, k, v, do = (_bh(a).to(dt) for a in _inputs(case, seed=1))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    ga = torch.autograd.grad(TF.flash_fwd_plain(*a, **kw), a, do)
    p = [t.clone().requires_grad_() for t in (q, k, v)]
    gp = torch.autograd.grad(TF.flash_fwd_trainable(*p, **kw), p, do)
    for name, x, y in zip("qkv", gp, ga):
        assert x.dtype == dt
        assert _rel(x.float(), y.float()) <= (
            RTOL if dtype == "float32" else BF16_TOL), name


def test_gqa_gradients_sum_over_the_repeated_heads():
    """K/V of 2 heads repeated to 4 query heads (`repeat_kv`): the
    Function's dK and dV, summed back by autograd, equal autograd through
    the plain version."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 24, 4, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 16)).astype(
        np.float32)) for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((2, 24, 4, 16)).astype(
        np.float32))

    def grads(fn):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        with mock.patch.object(TA, "flash_fwd_kernel", fn):
            out = TA.flash_attention(xs[0], TA.repeat_kv(xs[1], 4),
                                     TA.repeat_kv(xs[2], 4))
        return torch.autograd.grad(out, xs, do)

    ours = grads(lambda *a, **kw: TF.FlashFwd.apply(
        *a, kw["causal"], kw["window"], kw["q_offset"]))
    plain = grads(TF.flash_fwd_plain)
    for name, x, y in zip("qkv", ours, plain):
        assert x.shape == y.shape and _rel(x, y) <= RTOL, name


def test_cpu_attention_runs_the_plain_version_under_autograd():
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    out = TA.flash_attention(q, q, q)
    assert "FlashFwd" not in type(out.grad_fn).__name__
    out.sum().backward()
    assert q.grad is not None and float(q.grad.abs().max()) > 0


def test_matmul_f32_gradient_matches_the_reference():
    """f32 operands (the CPU path): matmul_f32's gradient against the
    reference's ``einsum(..., preferred_element_type=f32)``."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    g = rng.standard_normal((2, 5, 12)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, y: jnp.einsum(
        "btd,dv->btv", x, y, preferred_element_type=jnp.float32),
        jnp.asarray(a), jnp.asarray(w))
    ra, rw = vjp(jnp.asarray(g))
    at, wt = (torch.from_numpy(x).requires_grad_() for x in (a, w))
    ga, gw = torch.autograd.grad(TL.matmul_f32(at, wt), (at, wt),
                                 torch.from_numpy(g))
    assert _rel(ga, ra) <= RTOL and _rel(gw, rw) <= RTOL


@pytest.mark.parametrize("batched", [False, True])
def test_matmul_f32_function_backward(batched):
    """`_MatmulF32`'s backward on bf16 operands, its f32-out product
    stood in for on the CPU (which has no ``mm`` with an ``out_dtype``):
    bit-equal to autograd through the product of the f32 copies, each
    gradient in its operand's dtype."""
    gen = torch.Generator().manual_seed(4)
    if batched:
        a = torch.randn(3, 6, 16, generator=gen).bfloat16()
        b = torch.randn(3, 16, 10, generator=gen).bfloat16()
    else:
        a = torch.randn(2, 6, 16, generator=gen).bfloat16()
        b = torch.randn(16, 10, generator=gen).bfloat16()
    g = torch.randn(*a.shape[:-1], 10, generator=gen)
    stand_in = lambda x, y: torch.matmul(x.float(), y.float())
    x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
    with mock.patch.object(TL, "_mm_f32", stand_in):
        out = TL._MatmulF32.apply(x, y)
    assert out.dtype == torch.float32
    gx, gy = torch.autograd.grad(out, (x, y), g)
    x2, y2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    rx, ry = torch.autograd.grad(stand_in(x2, y2), (x2, y2), g)
    assert gx.dtype == gy.dtype == torch.bfloat16
    assert torch.equal(gx, rx) and torch.equal(gy, ry)


def test_remat_recomputes_inside_precision_flow():
    """Granite-MoE reduced in bf16 with ``bf16_flow``: its experts'
    products emit bf16 inside ``precision_flow(True)``, f32 outside.  The
    backward runs after `loss_fn` has left the context, so a checkpointed
    group's recompute must enter it again: the gradients with remat equal
    those without, bit for bit."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduce(),
                              param_dtype="bfloat16", bf16_flow=True)
    params = init_params(TT.lm_schema(cfg), 0, dtype=cfg.dtype,
                         device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        LMBatchSpec(2, 16, cfg.vocab), seed=0).batch_at(0).items()}
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = sb._grads_of(params, batch, c)
    assert torch.equal(out[True][0], out[False][0])
    for x, y in zip(out[True][2], out[False][2]):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
