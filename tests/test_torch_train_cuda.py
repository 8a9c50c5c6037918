"""Training on the card: the flash kernel under autograd, the f32-out
product's derivative, and a training step, against plain versions.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
where there is none.  The file imports no JAX (its CPU counterparts, held
to the reference, are in `test_torch_flash_grad.py` and
`test_torch_train_step.py`).  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest tests/test_torch_train_cuda.py -q

- `flash_fwd_trainable` (the kernel forward, `flash_bwd_plain` backward)
  against autograd through `flash_fwd_plain` on the card: f32 within
  1e-5 of max|grad|, bf16 within 2e-2; one kernel launch a forward;
- the training forward's attention takes it only under grad mode;
- `matmul_f32` on bf16 operands under autograd (PyTorch has no
  derivative for ``mm`` with an ``out_dtype``): the forward bit-equal to
  the no-grad product, each gradient within a bf16 ulp of autograd
  through the f32 product;
- a reduced Qwen1.5-4B (f32) step on the card against the same step on
  the CPU within 1e-5, with 2 flash launches a layer (forward and remat
  recompute).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import LMBatchSpec, SyntheticLM
from repro_torch.kernels import flash as TF
from repro_torch.launch import step_builders as sb
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.layers import init_params
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.utils.tree import leaves, tree_map

pytestmark = pytest.mark.gpu

RTOL = 1e-5
BF16_TOL = 2e-2


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inputs(case, seed=0):
    b, h, tq, tk, hd = case[:5]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(s).astype(np.float32) for s in (
        (b, tq, h, hd), (b, tk, h, hd), (b, tk, h, hd), (b, tq, h, hd)))


def _bh(a):
    """(B, T, H, hd) numpy -> (B*H, T, hd) tensor."""
    t = torch.from_numpy(a)
    b, n, h, hd = t.shape
    return t.transpose(1, 2).reshape(b * h, n, hd).contiguous()


def _graph_has(fn, name: str) -> bool:
    """Whether the autograd graph below ``fn`` holds a node ``name``."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        if type(f).__name__ == name:
            return True
        todo.extend(g for g, _ in f.next_functions)
    return False


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CUDA_CASES = [
    (2, 2, 48, 48, 16, True, None, 0),
    (1, 3, 40, 40, 32, True, 9, 0),
    (2, 2, 30, 30, 16, False, None, 0),
    (1, 2, 16, 24, 16, True, None, 8),
    (1, 2, 300, 300, 8, True, None, 0),
    (2, 20, 512, 512, 128, True, None, 0),  # Qwen's, a microbatch
    (1, 4, 257, 257, 64, True, 100, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_function_matches_autograd_through_plain(cuda, case, dtype):
    b, h, tq, tk, hd, causal, window, q_offset = case
    dt = getattr(torch, dtype)
    q, k, v, do = (_bh(a).to(cuda, dt) for a in _inputs(case, seed=5))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    ga = torch.autograd.grad(TF.flash_fwd_plain(*a, **kw), a, do)
    n0 = TF.flash_fwd_kernel.launches
    p = [t.clone().requires_grad_() for t in (q, k, v)]
    out = TF.flash_fwd_trainable(*p, **kw)
    assert TF.flash_fwd_kernel.launches == n0 + 1
    gp = torch.autograd.grad(out, p, do)
    for name, x, y in zip("qkv", gp, ga):
        assert x.dtype == dt and x.device.type == "cuda"
        assert _rel(x.float().cpu(), y.float().cpu()) <= (
            RTOL if dtype == "float32" else BF16_TOL), name


def test_cuda_training_attention_takes_the_function(cuda):
    q = torch.randn(2, 64, 4, 32, device=cuda, dtype=torch.bfloat16)
    n0 = TF.flash_fwd_kernel.launches
    with torch.no_grad():
        out = TA.flash_attention(q, q, q)
    assert out.grad_fn is None
    qg = q.clone().requires_grad_()
    out = TA.flash_attention(qg, qg, qg)
    assert _graph_has(out.grad_fn, "FlashFwdBackward")
    assert TF.flash_fwd_kernel.launches == n0 + 2
    out.float().sum().backward()
    assert float(qg.grad.float().abs().max()) > 0


@pytest.mark.parametrize("shape", [((2, 64, 256), (256, 96)),
                                   ((4, 32, 64), (4, 64, 48))])
def test_cuda_matmul_f32_is_differentiable_in_bf16(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn(*shape[0], generator=gen, device=cuda).bfloat16()
    b = torch.randn(*shape[1], generator=gen, device=cuda).bfloat16()
    g = torch.randn(*shape[0][:-1], shape[1][-1], generator=gen,
                    device=cuda)
    x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = TL.matmul_f32(x, y)
    assert out.dtype == torch.float32
    assert torch.equal(out.detach(), TL.matmul_f32(a, b))
    gx, gy = torch.autograd.grad(out, (x, y), g)
    x2, y2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    rx, ry = torch.autograd.grad(torch.matmul(x2.float(), y2.float()),
                                 (x2, y2), g)
    assert gx.dtype == gy.dtype == torch.bfloat16
    assert _rel(gx.float().cpu(), rx.float().cpu()) <= 2 ** -8
    assert _rel(gy.float().cpu(), ry.float().cpu()) <= 2 ** -8


def test_cuda_reduced_qwen_step_matches_the_cpu_step(cuda):
    """Reduced Qwen1.5-4B (f32) trained 2 steps on the card (flash under
    autograd, f32 FMAs, TF32 off) and on the CPU from the same weights
    (its zero-initialized leaves given seeded values, as the CPU tests'
    weights: a leaf that starts at zero holds nothing but AdamW updates,
    whose near-zero-gradient elements carry the two devices' summation
    noise): losses, grad norms and ce within 1e-5; each parameter leaf
    within 1e-5 in the L2 norm, each element within 1e-5 of max|p| plus
    half the steps' summed lr (the bounds of `test_torch_train_step.py`).
    Two flash launches a layer a step (forward and remat recompute)."""
    cfg = get_config("qwen1.5-4b").reduce()
    data = SyntheticLM(LMBatchSpec(4, 32, cfg.vocab), seed=0)
    gen = torch.Generator().manual_seed(1)
    start = init_params(TT.lm_schema(cfg), 0, dtype=cfg.dtype, device="cpu")
    for p in leaves(start):
        if not p.any():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    lr_sum = sum(float(warmup_cosine(3e-4, 200, 10_000)(s))
                 for s in (100, 101))
    results = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda p: p.to(dev, copy=True), start)
        state = sb.make_optimizer(cfg).init(params)
        step = sb.build_train(cfg, ShapeSpec("t", 32, 4, "train"))
        n0 = TF.flash_fwd_kernel.launches
        ms = []
        for s in (100, 101):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch_at(s).items()}
            params, state, m = step(params, state, batch, s)
            ms.append({k: float(v) for k, v in m.items()})
        launches = TF.flash_fwd_kernel.launches - n0
        results[str(dev)] = (ms, [p.cpu() for p in leaves(params)],
                             launches)
    (m_cpu, p_cpu, _), (m_gpu, p_gpu, n) = results["cpu"], \
        results[str(cuda)]
    assert n == 2 * 2 * cfg.total_layers  # forward + remat recompute
    for a, b in zip(m_gpu, m_cpu):
        for k in ("loss", "grad_norm", "ce"):
            assert _rel(a[k], b[k]) <= RTOL, k
    for a, b in zip(p_gpu, p_cpu):
        assert float((a - b).norm() / b.norm()) <= RTOL
        assert float((a - b).abs().max()) <= \
            RTOL * float(b.abs().max()) + 0.5 * lr_sum
