"""The step counter (`utils.cost`), the card's-path predicate and the
kernels' custom ops, on the CPU and the meta device.

- Hand-built ops under `CostCounter` on meta: exact FLOPs and bytes for
  ``mm``, ``bmm``, ``addmm``, ``conv2d`` (2 x result x contraction; the
  operands and the result once), a float ``mul`` (2 an element) against an
  integer one (0), a square (``pow`` by 2), views (0), gathers and
  scatters (2 x the result or the update), CPU tensors (no device bytes),
  `repeat` (the body's count times n, nested scopes multiply).
- Memory: the arguments' storages once, the peak of live storages, a
  temporary that only autograd holds kept live, a kernel's workspace.
- Each kernel's custom op on meta against its cost function
  (`flash_kernel_cost` with the CUDA kernel's query tile,
  `vsmm_kernel_cost` with a split plan's workspace), its CPU
  implementation bit-equal to the plain version, and the wrapper's
  checks raising on meta as on the card.
- `card_path`: the three branches that the card takes (``matmul_f32``'s
  one ``mm`` with an f32 output, the flash Function under grad, the
  decode scores read in place) are taken on meta, and not on the CPU.
- `scan`: every trip off meta; on meta one trip (outside autograd) or
  four (under it); the recurrent mixers' prefill and training steps
  counted with it equal, op by op, to the count with every trip run, at
  a small T, and their peak memory within 5%.
"""
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.device import card_path
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels import flash as TF
from repro_torch.kernels import vsmm as V
from repro_torch.launch import step_builders as sb
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM
from repro_torch.models import rwkv as TR
from repro_torch.utils import cost as C

F32, BF16 = torch.float32, torch.bfloat16


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _only(cost, op):
    assert list(cost.ops) == [op], cost.ops
    return cost.ops[op]


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_mm_and_bmm_count_two_flops_a_product_and_their_operands(dtype):
    n = dtype.itemsize
    a, b = _meta(8, 16, dtype=dtype), _meta(16, 32, dtype=dtype)
    _, c = C.count(torch.mm, a, b)
    assert (c.flops, c.bytes) == (2 * 8 * 16 * 32,
                                  (8 * 16 + 16 * 32 + 8 * 32) * n)
    assert _only(c, "aten.mm.default") == [1, c.flops, c.bytes]
    a, b = _meta(3, 8, 16, dtype=dtype), _meta(3, 16, 32, dtype=dtype)
    _, c = C.count(torch.bmm, a, b)
    assert (c.flops, c.bytes) == (2 * 3 * 8 * 16 * 32,
                                  3 * (8 * 16 + 16 * 32 + 8 * 32) * n)


def test_an_f32_out_product_counts_its_f32_result():
    a, b = _meta(8, 16, dtype=BF16), _meta(16, 32, dtype=BF16)
    _, c = C.count(torch.mm, a, b, out_dtype=F32)
    assert c.flops == 2 * 8 * 16 * 32
    assert c.bytes == (8 * 16 + 16 * 32) * 2 + 8 * 32 * 4
    assert list(c.ops) == ["aten.mm.dtype"]


def test_addmm_and_conv2d():
    bias, a, b = _meta(32), _meta(8, 16), _meta(16, 32)
    _, c = C.count(torch.addmm, bias, a, b)
    assert (c.flops, c.bytes) == (2 * 8 * 16 * 32,
                                  4 * (32 + 8 * 16 + 16 * 32 + 8 * 32))
    x, w = _meta(2, 3, 10, 10), _meta(5, 3, 3, 3)
    _, c = C.count(F.conv2d, x, w, padding=1)
    out = 2 * 5 * 10 * 10
    assert c.flops == 2 * out * 3 * 3 * 3
    assert c.bytes == 4 * (x.numel() + w.numel() + out)
    _, c = C.count(F.conv2d, _meta(2, 4, 10, 10), _meta(4, 1, 3, 3),
                   padding=1, groups=4)  # depthwise: 9 MACs an output
    assert c.flops == 2 * (2 * 4 * 10 * 10) * 9


def test_float_mul_counts_two_an_element_and_integer_mul_none():
    x = _meta(4, 6)
    _, c = C.count(torch.mul, x, x)
    assert (c.flops, c.bytes) == (2 * 24, 3 * 24 * 4)
    i = _meta(4, 6, dtype=torch.int32)
    _, c = C.count(torch.mul, i, i)
    assert (c.flops, c.bytes) == (0, 3 * 24 * 4)
    _, c = C.count(lambda t: t.mul_(2.0), _meta(4, 6))
    assert c.flops == 2 * 24 and c.bytes == 2 * 24 * 4
    _, c = C.count(torch.square, x)
    assert c.flops == 2 * 24
    _, c = C.count(lambda t: t ** 3, x)
    assert c.flops == 0
    _, c = C.count(torch.add, x, x)  # other elementwise ops: bytes only
    assert (c.flops, c.bytes) == (0, 3 * 24 * 4)


def test_views_count_nothing():
    def views(x):
        return (x.view(6, 4), x.t(), x.transpose(0, 1), x[1:], x.unbind(0),
                x.reshape(24), x[:, None].expand(4, 3, 6), x.detach())
    _, c = C.count(views, _meta(4, 6))
    assert (c.flops, c.bytes) == (0, 0)
    assert c.peak_bytes == c.arg_bytes == 24 * 4


def test_copies_gathers_and_scatters():
    x, y = _meta(4, 6), _meta(4, 6)
    _, c = C.count(lambda a, b: a.copy_(b), x, y)
    assert c.bytes == 2 * 24 * 4   # the source read, the destination once
    _, c = C.count(lambda a: a.zero_(), x)
    assert c.bytes == 24 * 4
    table, ids = _meta(1000, 8), _meta(2, 3, dtype=torch.int64)
    _, c = C.count(lambda w, i: w[i], table, ids)
    assert c.bytes == 2 * 6 * 8 * 4   # 2 x the rows gathered, not the table
    cache, slot, row = _meta(2, 50, 8), _meta(1, dtype=torch.int64), \
        _meta(2, 1, 8)
    _, c = C.count(lambda a, s, r: a.index_copy_(1, s, r), cache, slot, row)
    assert c.bytes == 2 * 16 * 4      # 2 x the update, not the cache


def test_only_the_counted_devices_bytes_count():
    x = torch.ones(4, 6)
    with C.CostCounter(device="meta") as counter:
        torch.mm(x, x.t())
    assert counter.cost.flops == 2 * 4 * 6 * 4
    assert counter.cost.bytes == 0 and counter.cost.peak_bytes == 0


def test_repeat_scales_the_body_and_nests():
    x = _meta(4, 6)

    def step(x):
        with C.repeat(5):
            y = x * x
            with C.repeat(3):
                y = y + x
        return y

    _, c = C.count(step, x)
    assert c.ops["aten.mul.Tensor"] == [5, 5 * 48, 5 * 3 * 96]
    assert c.ops["aten.add.Tensor"] == [15, 0, 15 * 3 * 96]
    # allocations are counted once: x, y and y + x live
    assert c.peak_bytes == 3 * 96


def _plain_scan(step, carry, t, x):
    ys = []
    for i in range(t):
        carry, y = step(carry, i)
        ys.append(y)
    return carry, ys


def test_scan_runs_every_trip_off_meta_and_fewer_on_meta():
    calls = []

    def step(c, i):
        calls.append(i)
        return c * 2 + 1, c + i

    x = torch.ones(3)
    carry, ys = C.scan(step, x, 6, x)
    want = _plain_scan(lambda c, i: (c * 2 + 1, c + i), x, 6, x)
    assert calls == list(range(6)) and torch.equal(carry, want[0])
    assert all(torch.equal(a, b) for a, b in zip(ys, want[1]))
    calls.clear()
    m = _meta(3)
    carry, ys = C.scan(step, m, 6, m)
    assert calls == [0] and len(ys) == 6 and carry.shape == (3,)
    calls.clear()
    g = _meta(3).requires_grad_()
    carry, ys = C.scan(step, g, 7, g)   # the first, one for 1-4, the last two
    assert calls == [0, 1, 5, 6] and len(ys) == 7
    assert [y.grad_fn is None for y in ys] == [False, False] + [True] * 3 \
        + [False, False]
    calls.clear()
    C.scan(step, g, 4, g)               # too few trips to stand in for
    assert calls == [0, 1, 2, 3]


def test_arguments_once_and_the_peak_of_live_storages():
    x = _meta(256, 256)   # 256 KiB
    n = x.numel() * 4

    def step(a, same):
        y = a + 1
        y = y + 1   # the first y dies once this one is made
        y = y + 1
        return y

    _, c = C.count(step, x, x[:10])   # a view of x: the same storage
    assert c.arg_bytes == n
    assert c.peak_bytes == 3 * n and c.temp_bytes == 2 * n


def test_a_storage_that_only_autograd_holds_stays_live():
    x = _meta(256, 256).requires_grad_()
    n = x.numel() * 4

    def step(a):
        e = torch.exp(a)     # ExpBackward saves its result
        s = e.sum()
        del e                # no Python reference left
        z = torch.ones_like(a)
        return s, z

    _, c = C.count(step, x)
    assert c.peak_bytes == 3 * n + 4   # x, exp(x) (saved), z, the sum


@pytest.mark.parametrize("dtype,hd,causal", [(BF16, 128, True),
                                              (BF16, 240, False),
                                              (F32, 64, True)])
def test_flash_op_on_meta_counts_its_cost_function(dtype, hd, causal):
    q, k = _meta(12, 300, hd, dtype=dtype), _meta(12, 320, hd, dtype=dtype)
    out, c = C.count(TF.flash_fwd_kernel, q, k, k, causal=causal,
                     q_offset=20)
    assert out.shape == q.shape and out.dtype == dtype
    want = TF.flash_kernel_cost(bh=12, tq=300, tk=320, hd=hd, causal=causal,
                                itemsize=dtype.itemsize,
                                block_q=TF.query_tile(dtype, hd),
                                q_offset=20)
    assert (c.flops, c.bytes) == (want["flops"], want["bytes_accessed"])
    assert c.kernels == {"flash_fwd": 1}
    assert list(c.ops) == ["repro_torch.flash_fwd.default"]
    assert TF.query_tile(dtype, hd) == {128: 128, 240: 64, 64: 64}[hd]
    bq = TF.query_tile(dtype, hd)
    assert want["bytes_accessed"] == dtype.itemsize * (
        2 * 12 * 300 * hd + -(-300 // bq) * 2 * 12 * 320 * hd)
    # causal: the mean keys a query sees, q_offset + Tq / 2 = 170 of 320
    assert want["flops"] == 4 * 12 * 300 * (170 if causal else 320) * hd
    square = TF.flash_kernel_cost(bh=12, tq=320, tk=320, hd=hd,
                                  causal=causal, itemsize=dtype.itemsize,
                                  block_q=TF.query_tile(dtype, hd))
    assert square["flops"] == 4 * 12 * 320 * 320 * hd // (2 if causal else 1)


def test_flash_wrapper_checks_operands_on_meta():
    with pytest.raises(ValueError, match="hd a multiple of 4"):
        TF.flash_fwd_kernel(_meta(2, 8, 6), _meta(2, 8, 6), _meta(2, 8, 6))
    with pytest.raises(ValueError, match="one dtype"):
        TF.flash_fwd_kernel(_meta(2, 8, 16), _meta(2, 8, 16, dtype=BF16),
                            _meta(2, 8, 16, dtype=BF16))


def test_flash_op_cpu_implementation_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 20, 16, generator=g) for _ in range(3))
    for causal, window in ((True, None), (True, 5), (False, None)):
        want = TF.flash_fwd_plain(q, k, v, causal=causal, window=window,
                                  q_offset=2)
        assert torch.equal(torch.ops.repro_torch.flash_fwd(
            q, k, v, causal, window, 2), want)
        assert torch.equal(TF.flash_fwd_kernel(
            q, k, v, causal=causal, window=window, q_offset=2), want)


def _vs(nb, s, vk, vn, k, dtype, device):
    vals = torch.randn(nb, s, vk, vn).to(dtype).to(device)
    idx = (torch.arange(s, dtype=torch.int32) % (k // vk)).expand(
        nb, s).contiguous().to(device)
    return VectorSparse(vals=vals, idx=idx, shape=(k, nb * vn))


def test_vsmm_op_on_meta_counts_its_cost_function_and_workspace():
    vs = _vs(4, 40, 32, 64, 1280, BF16, "meta")
    x = _meta(8, 1280, dtype=BF16)
    rows, splits = V.vsmm_bf16_plan(8, 4, 40, 32, 64)
    assert splits > 1   # a decode-shaped product splits its steps
    out, c = C.count(V.vsmm_kernel, x, vs, out_dtype=F32)
    assert out.shape == (8, 256) and out.dtype == F32
    want = V.vsmm_kernel_cost(m=8, nb=4, s_steps=40, vk=32, vn=64,
                              in_itemsize=2, w_itemsize=2, out_itemsize=4)
    assert (c.flops, c.bytes) == (want["flops"], want["bytes_accessed"])
    assert c.kernels == {"vsmm": 1}
    # x (the argument) and the output live, the f32 workspace of each
    # chunk's partial for the launch
    assert c.peak_bytes == x.numel() * 2 + 8 * 256 * 4 + splits * 8 * 256 * 4
    _, c = C.count(V.vsmm_kernel, x, vs, residual=_meta(8, 256))
    want = V.vsmm_kernel_cost(m=8, nb=4, s_steps=40, vk=32, vn=64,
                              in_itemsize=2, w_itemsize=2, out_itemsize=2,
                              residual_bytes=8 * 256 * 4)   # bf16 out
    assert c.bytes == want["bytes_accessed"]


def test_vsmm_wrapper_checks_operands_on_meta():
    vs = _vs(4, 3, 8, 16, 48, BF16, "meta")
    with pytest.raises(ValueError, match="does not match"):
        V.vsmm_kernel(_meta(5, 40, dtype=BF16), vs)
    with pytest.raises(ValueError, match="contiguous"):
        V.vsmm_kernel(_meta(5, 48), vs)   # f32 x, bf16 tiles


def test_vsmm_op_cpu_implementation_is_the_plain_version():
    vs = _vs(4, 3, 8, 16, 48, F32, "cpu")
    x = torch.randn(5, 48)
    bias = torch.randn(64)
    want = V.vsmm_plain(x, vs, bias=bias, fuse_relu=True)
    got = torch.ops.repro_torch.vsmm(x, vs.vals, vs.idx, bias, None, None,
                                     True, True, None)
    assert torch.equal(got, want)
    assert torch.equal(V.vsmm_kernel(x, vs, bias=bias, fuse_relu=True),
                       want)


def test_card_path():
    assert card_path(_meta(1)) and not card_path(torch.ones(1))


def test_meta_takes_the_cards_branches():
    a, b = _meta(4, 8, 16, dtype=BF16), _meta(16, 32, dtype=BF16)
    _, c = C.count(TL.matmul_f32, a, b)
    assert set(c.ops) == {"aten.view.default", "aten.mm.dtype"}  # no copy
    _, c = C.count(lambda x, y: TL.matmul_f32(x.float(), y.float()),
                   a, b)   # f32 operands: the plain product
    assert "aten.mm.default" in c.ops
    cache = _meta(2, 40, 2, 16, dtype=BF16)
    qg = _meta(2, 2, 3, 16, dtype=BF16)
    _, c = C.count(TA._decode_scores, qg, cache)
    assert "aten.bmm.dtype" in c.ops and "aten._to_copy.default" not in c.ops
    q = _meta(1, 8, 2, 16, dtype=BF16).requires_grad_()
    assert _graph_has(TA.flash_attention(q, q, q).grad_fn, "FlashFwd")
    cpu = torch.ones(1, 8, 2, 16, requires_grad=True)
    assert not _graph_has(TA.flash_attention(cpu, cpu, cpu).grad_fn,
                          "FlashFwd")


def _graph_has(fn, name: str) -> bool:
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        if name in type(f).__name__:
            return True
        todo.extend(g for g, _ in f.next_functions)
    return False


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_scan_counts_the_loop_as_every_trip(arch, kind):
    """The recurrent mixers' loops over T on meta: the count with `scan`
    (one trip standing for all, or under autograd for all but the first
    and the last two, its backward scaled) equal to the count with every
    trip run, op by op, the training step's remat and backward
    included."""
    cfg = get_config(arch).reduce()
    step = sb.build(cfg, ShapeSpec("p", 9, 2, kind))
    out, once = C.count(step.fn, *step.args)
    with mock.patch.object(TR, "scan", _plain_scan), \
            mock.patch.object(TM, "scan", _plain_scan):
        out_all, unrolled = C.count(step.fn, *step.args)
    assert (once.flops, once.bytes) == (unrolled.flops, unrolled.bytes)
    assert once.ops == unrolled.ops
    assert once.ops["aten.stack.default"][0] > 0
    # memory: each standing-in trip's live storages counted per trip
    assert abs(once.peak_bytes - unrolled.peak_bytes) <= \
        0.05 * unrolled.peak_bytes
