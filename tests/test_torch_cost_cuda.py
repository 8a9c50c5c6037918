"""The kernels as custom ops, and the meta count against the card's count
(on the card only; JAX-free).

Marked ``gpu`` (the ``cuda`` fixture skips without a card):

- each custom op (``repro_torch::flash_fwd``, ``repro_torch::vsmm``)
  bit-equal to the kernel's ctypes launch called directly, as the
  wrappers called it before the op existed, with one count a call;
- the launch counters exact under a CUDA graph's capture and replays,
  and the replays bit-equal to the eager calls;
- `FlashFwd`'s gradients unchanged: `flash_bwd_plain` on the kernel's
  output, bit for bit;
- reduced configs in bf16 (the card's branches) counted on meta and on
  the card: FLOPs, bytes, kernel launches, every op's tally and the
  arguments' bytes equal (and the peak, but where meta stands one trip
  of a recurrent loop in for many), the recurrent archs' training steps
  included.

Run on the H100:

    PYTHONPATH=src python -m pytest tests/test_torch_cost_cuda.py -q
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels import capture as TC
from repro_torch.kernels import flash as TF
from repro_torch.kernels import vsmm as V
from repro_torch.kernels._build import launch
from repro_torch.launch import step_builders as sb
from repro_torch.models import transformer as TT
from repro_torch.models.layers import init_params
from repro_torch.utils.cost import count

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flash_launch(q, k, v, causal, window, q_offset):
    """The kernel's launch as the wrapper made it before the custom op."""
    out = torch.empty_like(q)
    launch("flash_fwd", "flash_fwd_launch", (q, k, v, out),
           (q.shape[0], q.shape[1], k.shape[1], q.shape[2], int(causal),
            -1 if window is None else window, q_offset,
            int(q.dtype == BF16)), q.device)
    return out


FLASH_CASES = [(BF16, 40, 512, 512, 128, True, None, 0),
               (BF16, 6, 130, 300, 64, True, 50, 170),
               (F32, 6, 77, 77, 80, False, None, 0),
               (BF16, 4, 200, 200, 240, True, None, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_op_is_the_launch_bit_for_bit(cuda, case):
    dt, bh, tq, tk, hd, causal, window, off = case
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(bh, tq, hd, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(bh, tk, hd, generator=g, device=cuda).to(dt)
            for _ in range(2))
    n0 = TF.flash_fwd_kernel.launches
    got = TF.flash_fwd_kernel(q, k, v, causal=causal, window=window,
                              q_offset=off)
    assert TF.flash_fwd_kernel.launches == n0 + 1
    want = _flash_launch(q, k, v, causal, window, off)
    assert torch.equal(got, want)
    assert torch.equal(torch.ops.repro_torch.flash_fwd(
        q, k, v, causal, window, off), want)
    assert TF.flash_fwd_kernel.launches == n0 + 2


def _vsmm_launch(x, vs, out_dtype, int8=False, scale=None):
    m = x.shape[0]
    nb, s_steps, vk, vn = vs.vals.shape
    bf16 = x.dtype == BF16
    rows, splits = (V.vsmm_bf16_plan(m, nb, s_steps, vk, vn) if bf16
                    else V.vsmm_plan(m, nb, s_steps, vk, vn, int8))
    out = torch.empty((m, nb * vn), dtype=out_dtype, device=x.device)
    work = None
    if splits > 1:
        work = torch.empty((splits, m, nb * vn, 2) if int8
                           else (splits, m, nb * vn),
                           dtype=torch.int32 if int8 else F32,
                           device=x.device)
    launch("vsmm", V.entry_name("vsmm_launch", int8, bf16),
           (x, vs.vals, vs.idx, scale, None, None, out, work),
           (m, x.shape[1], nb, s_steps, vk, vn, 0, 1, splits, rows,
            int(out_dtype == BF16)), x.device)
    return out, splits


def _vs(nb, s, vk, vn, k, dtype, dev, g):
    vals = torch.randn(nb, s, vk, vn, generator=g, device=dev)
    if dtype == torch.int8:
        vals = vals.mul(40).round().clamp(-127, 127)
    idx = torch.stack([torch.randperm(k // vk, generator=g,
                                      device=dev)[:s].sort().values
                       for _ in range(nb)]).int()
    return VectorSparse(vals=vals.to(dtype), idx=idx, shape=(k, nb * vn))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,m", [(BF16, 8), (BF16, 1024), (F32, 8),
                                     (F32, 300), (torch.int8, 64)])
def test_vsmm_op_is_the_launch_bit_for_bit(cuda, dtype, m):
    g = torch.Generator(device=cuda).manual_seed(1)
    vs = _vs(20, 24, 32, 64, 2560, dtype, cuda, g)
    x = torch.randn(m, 2560, generator=g, device=cuda)
    scale = None
    if dtype == torch.int8:
        x = x.mul(30).round().clamp(-127, 127)
        scale = torch.rand(20 * 64, generator=g, device=cuda)
    x = x.to(dtype)
    out_dtype = F32
    before = (V.vsmm_kernel.launches, V.vsmm_kernel.bf16_launches,
              V.vsmm_kernel.int8_launches)
    got = V.vsmm_kernel(x, vs, scale=scale, out_dtype=out_dtype)
    assert (V.vsmm_kernel.launches, V.vsmm_kernel.bf16_launches,
            V.vsmm_kernel.int8_launches) == (
        before[0] + 1, before[1] + (dtype == BF16),
        before[2] + (dtype == torch.int8))
    want, _ = _vsmm_launch(x, vs, out_dtype, dtype == torch.int8, scale)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_counters_exact_under_graph_replay(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(8, 256, 128, generator=g, device=cuda).to(BF16)
    vs = _vs(16, 30, 32, 64, 1024, BF16, cuda, g)
    x = torch.randn(8, 1024, generator=g, device=cuda).to(BF16)
    assert V.vsmm_bf16_plan(8, 16, 30, 32, 64)[1] > 1   # split: 2 kernels

    def fn():
        return (TF.flash_fwd_kernel(q, q, q),
                V.vsmm_kernel(x, vs, out_dtype=F32))

    eager = fn()
    n0 = (TF.flash_fwd_kernel.launches, V.vsmm_kernel.launches,
          V.vsmm_kernel.bf16_launches)
    graph, out = TC.capture(fn)   # the warm-up counts, the capture not
    assert graph.launches == {(TF.flash_fwd_kernel, "launches"): 1,
                              (V.vsmm_kernel, "launches"): 1,
                              (V.vsmm_kernel, "bf16_launches"): 1}
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert (TF.flash_fwd_kernel.launches, V.vsmm_kernel.launches,
            V.vsmm_kernel.bf16_launches) == tuple(n + 4 for n in n0)
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_function_gradients_unchanged(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(10, 96, 64, generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    p = [t.clone().requires_grad_() for t in (q, k, v)]
    out = TF.FlashFwd.apply(*p, True, 40, 3)
    assert "FlashFwdBackward" in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, p, do)
    ref_out = _flash_launch(q, k, v, True, 40, 3)
    assert torch.equal(out.detach(), ref_out)
    want = TF.flash_bwd_plain(q, k, v, ref_out, do, causal=True, window=40,
                              q_offset=3)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)


def _card_args(step, vocab):
    """The built step's arguments on the card, with valid token ids."""
    g = torch.Generator(device="cuda").manual_seed(4)
    args = list(step.args)
    for tree in args[1:]:
        if isinstance(tree, dict):
            for key in ("tokens", "labels"):
                if key in tree:
                    tree[key].copy_(torch.randint(
                        0, vocab, tree[key].shape, generator=g,
                        device="cuda"))
    if len(args) == 4 and isinstance(args[2], torch.Tensor) and \
            not args[2].is_floating_point():   # decode's tokens
        args[2].copy_(torch.randint(0, vocab, args[2].shape, generator=g,
                                    device="cuda"))
    return args


COUNT_CASES = [("qwen1.5-4b", "train", {"microbatches": 2}),
               ("qwen1.5-4b", "prefill", {}), ("qwen1.5-4b", "decode", {}),
               ("qwen1.5-4b", "prefill", {"use_sparse_ffn": True}),
               ("qwen1.5-4b", "decode", {"use_sparse_ffn": True}),
               ("rwkv6-3b", "prefill", {}), ("rwkv6-3b", "decode", {}),
               ("rwkv6-3b", "train", {}),
               ("jamba-v0.1-52b", "prefill", {}),
               ("jamba-v0.1-52b", "train", {}),
               ("granite-moe-3b-a800m", "train", {})]
# meta runs these archs' scans in stand-in trips, so their peaks differ
LOOPS = ("rwkv6-3b", "jamba-v0.1-52b")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kind,change", COUNT_CASES)
def test_meta_count_is_the_cards_count(cuda, arch, kind, change):
    cfg = dataclasses.replace(get_config(arch).reduce(),
                              param_dtype="bfloat16",
                              cache_dtype_str="bfloat16", **change)
    shape = ShapeSpec("s", 24, 4, kind)
    step = sb.build(cfg, shape)
    _, meta = count(step.fn, *step.args)
    params = init_params(TT.lm_schema(cfg), 0, dtype=cfg.dtype, device=cuda,
                         draw_on_device=True)
    card_step = sb.build(cfg, shape, cuda, params)
    args = _card_args(card_step, cfg.vocab)
    _, card = count(card_step.fn, *args)
    torch.cuda.synchronize()
    diff = {op: (meta.ops.get(op), card.ops.get(op))
            for op in set(meta.ops) | set(card.ops)
            if meta.ops.get(op) != card.ops.get(op)}
    assert (meta.flops, meta.bytes, meta.kernels) == \
        (card.flops, card.bytes, card.kernels), diff
    assert not diff
    assert meta.arg_bytes == card.arg_bytes
    if arch not in LOOPS:
        assert meta.peak_bytes == card.peak_bytes
