"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
where there is none (this decision is made inside the fixture, never at
import time, so every worker collects the same tests).  Run on a machine
with an H100:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerance: relative 1e-5 of max|y|.  The kernels and the plain versions
multiply the same f32 numbers; only the order of the f32 sums differs.
The flash kernel in bf16 (its tensor-core body): 1e-2, since it rounds p
to bf16 at the running max of its own kv tiles (64 keys), the plain
version at that of its blocks (up to 512): a bf16 ulp (2^-8 relative) of
an element here and there.  The int8 branches: bit for bit (every stored
step's partial is an exact integer, added in stored order on both sides).
"""
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core.vector_sparse import (VectorSparse, conv_cin_major,
                                            from_mask)
from repro_torch.core.pruning import prune_vectors_balanced
from repro_torch.configs import get_config
from repro_torch.kernels import flash as TF
from repro_torch.kernels import ops
from repro_torch.kernels import vsconv_dw as TD
from repro_torch.kernels.vsconv import (build_halo_input, build_row_tap_stack,
                                        use_stem_body, vsconv_halo_kernel,
                                        vsconv_plain, vsconv_stack_kernel,
                                        vsconv_stack_plain)
from repro_torch.kernels.vsconv_dw import (vsconv_dw_halo_kernel,
                                           vsconv_dw_plain,
                                           vsconv_dw_stack_kernel,
                                           vsconv_dw_stack_plain)
from repro_torch.kernels.vsmm import vsmm_kernel, vsmm_plain
from repro_torch.launch import serve as TS
from repro_torch.models import attention as TA
from repro_torch.models import graph as TG
from repro_torch.models.layers import init_params

pytestmark = pytest.mark.gpu

RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _sparse(rng, k, n, vk, vn, density, device):
    w = rng.standard_normal((k, n)).astype(np.float32)
    wp, mask = prune_vectors_balanced(w, density, vk, vn)
    return from_mask(torch.as_tensor(wp, device=device), mask, vk, vn)


def _relu_input(rng, shape, device, zero=False):
    """Post-ReLU-like activations, with whole zero runs so the input-side
    skip fires (all zeros with ``zero``: every tile is skipped)."""
    x = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
    x[..., : shape[-1] // 4] = 0
    if zero:
        x[:] = 0
    return torch.as_tensor(x, device=device)


@pytest.mark.parametrize("m,k,n,vk,vn,density", [
    (37, 64, 20, 8, 10, 0.5),       # ragged M, vn = 10 (a 10-class head)
    (300, 256, 256, 32, 128, 0.25),
    (8, 512, 1024, 32, 128, 0.235),  # the 224 px FC head at batch 8
])
@pytest.mark.parametrize("epilogue", [False, True])
def test_vsmm_kernel_matches_plain(cuda, m, k, n, vk, vn, density,
                                   epilogue):
    rng = np.random.default_rng(m + k)
    vs = _sparse(rng, k, n, vk, vn, density, cuda)
    x = _relu_input(rng, (m, k), cuda)
    kw = {}
    if epilogue:
        kw = dict(bias=torch.randn(n, device=cuda),
                  residual=torch.randn(m, n, device=cuda), fuse_relu=True)
    before = vsmm_kernel.launches
    y = vsmm_kernel(x, vs, **kw)
    torch.cuda.synchronize()
    assert vsmm_kernel.launches == before + 1
    assert _rel(y, vsmm_plain(x, vs, **kw)) <= RTOL


@pytest.mark.parametrize("size,cin,cout,kh,stride,vk,vn", [
    (32, 8, 64, 7, 2, 8, 64),     # the stem after cin padding 3 -> 8
    (16, 64, 64, 3, 1, 32, 64),
    (16, 64, 128, 3, 2, 32, 128),
    (3, 128, 128, 3, 1, 32, 128),  # Hout < 4 (the reference's resident body)
])
@pytest.mark.parametrize("epilogue", [False, True])
def test_vsconv_kernel_matches_plain(cuda, size, cin, cout, kh, stride, vk,
                                     vn, epilogue):
    rng = np.random.default_rng(size + cin + kh)
    vs = _sparse(rng, kh * kh * cin, cout, vk, vn, 0.5, cuda)
    x = _relu_input(rng, (2, size, size, cin), cuda)
    xh = build_halo_input(x, kh=kh, kw=kh, stride=stride, vk=vk)
    ho = -(-size // stride)
    kw = dict(w_out=ho, kh=kh, kw=kh, stride=stride)
    if epilogue:
        kw.update(bias=torch.randn(cout, device=cuda), fuse_relu=True,
                  residual=torch.randn(2, ho, ho, cout, device=cuda))
    before = vsconv_halo_kernel.launches
    y = vsconv_halo_kernel(xh, vs, **kw)
    torch.cuda.synchronize()
    assert vsconv_halo_kernel.launches == before + 1
    assert y.shape == (2, ho, ho, cout)
    assert _rel(y, vsconv_plain(xh, vs, **kw)) <= RTOL


@pytest.mark.parametrize("size,kh,stride,cin,vk,vn", [
    (12, 3, 1, 64, 32, 64),   # the generic body
    (19, 7, 2, 8, 8, 64),     # the stem body, a pruned stem weight
])
@pytest.mark.parametrize("impl", ["halo", "stack"])
def test_kernel_decodes_tiles_in_any_order(cuda, size, kh, stride, cin, vk,
                                           vn, impl):
    """The conv kernel decodes each stored id as given: reversing every
    strip's tile order changes nothing but the f32 summation order."""
    rng = np.random.default_rng(5)
    vs = _sparse(rng, kh * kh * cin, 64, vk, vn, 0.5, cuda)
    rev = VectorSparse(vs.vals.flip(1).contiguous(),
                       vs.idx.flip(1).contiguous(), vs.shape)
    x = _relu_input(rng, (1, size, size, cin), cuda)
    kw = dict(kh=kh, kw=kh, stride=stride, impl=impl)
    kernel = vsconv_halo_kernel if impl == "halo" else vsconv_stack_kernel
    stem = use_stem_body(cin, vk, 1, kh, kh, vn, stride=stride)
    assert stem == (cin == 8)
    before = kernel.stem_launches
    y = ops.vsconv(x, vs, **kw)
    assert _rel(ops.vsconv(x, rev, **kw), y) <= RTOL
    assert kernel.stem_launches == before + 2 * stem


def test_cuda_tensor_the_kernel_cannot_take_raises(cuda):
    rng = np.random.default_rng(6)
    vs = _sparse(rng, 64, 256, 32, 256, 0.5, cuda)  # vn 256 > 128
    with pytest.raises(ValueError, match="vn <= 128"):
        vsmm_kernel(torch.ones(4, 64, device=cuda), vs)
    with pytest.raises(ValueError, match="contiguous"):
        vsmm_kernel(torch.ones(64, 4, device=cuda).t(),
                    _sparse(rng, 64, 64, 32, 64, 0.5, cuda))


def test_resnet18_kernels_match_plain(cuda):
    """ResNet-18 at 32 px: the kernel path (17 halo convs, 3 projections +
    the head through vsmm) agrees with the plain path on the card."""
    net = TG.build_resnet18(10)
    params = init_params(net.schema(), 0, device=cuda)
    sparse, _ = TG.sparsify(net, params, 0.5)
    x = torch.randn(2, 32, 32, 3, device=cuda)
    vsmm_kernel.launches = vsconv_halo_kernel.launches = 0
    vsconv_halo_kernel.stem_launches = 0
    y = TG.net_apply(net, params, x, sparse=sparse, impl="auto")
    assert (vsconv_halo_kernel.launches, vsmm_kernel.launches) == (17, 4)
    assert vsconv_halo_kernel.stem_launches == 1
    y_plain = TG.net_apply(net, params, x, sparse=sparse, impl="plain")
    assert y.shape == (2, 10)
    assert _rel(y, y_plain) <= RTOL


def _conv_kwargs(cuda, n, ho, wo, cout, kh, stride, dilation, epilogue):
    kw = dict(w_out=wo, kh=kh, kw=kh, stride=stride, dilation=dilation)
    if epilogue:
        kw.update(bias=torch.randn(cout, device=cuda), fuse_relu=True,
                  residual=torch.randn(n, ho, wo, cout, device=cuda))
    return kw


@pytest.mark.parametrize("size,cin,cout,kh,stride,dil,groups,vk,vn,zero", [
    (32, 8, 64, 7, 2, 1, 1, 8, 64, False),   # the ResNet-18 stem, cin 3 -> 8
    (16, 64, 64, 3, 1, 1, 1, 32, 64, False),
    (16, 64, 128, 3, 2, 1, 1, 32, 128, False),
    (15, 64, 64, 3, 2, 2, 4, 16, 16, False),  # grouped, dilated, odd size
    (16, 64, 64, 3, 1, 1, 4, 16, 16, False),  # grouped 3x3, 4 groups
    (32, 8, 32, 3, 2, 1, 1, 8, 32, False),   # the MobileNetV1 stem
    (15, 8, 32, 3, 2, 1, 1, 8, 32, False),   # stems at odd sizes: Hout 8
    (33, 8, 64, 7, 2, 1, 1, 8, 64, False),   # and 17 cut the 8 x 16 tile
    (20, 16, 64, 5, 1, 2, 1, 8, 32, False),  # stem body: 2 cin tiles, dil 2
    (16, 8, 32, 3, 2, 1, 1, 8, 32, True),    # all zeros: the stem's skip
])
@pytest.mark.parametrize("layout", ["halo", "stack"])
@pytest.mark.parametrize("epilogue", [False, True])
def test_conv_kernels_match_plain(cuda, size, cin, cout, kh, stride, dil,
                                  groups, vk, vn, zero, layout, epilogue):
    """The halo kernel (now grouped too) and the stack kernel against their
    plain versions on the card; the stem-shaped cases run the stem body
    (``stem_launches`` moves), the others the generic one."""
    rng = np.random.default_rng(size + cin + kh + groups)
    vs = _sparse(rng, kh * kh * cin // groups, cout, vk, vn, 0.5, cuda)
    x = _relu_input(rng, (2, size, size, cin), cuda, zero)
    ho = -(-size // stride)
    kw = _conv_kwargs(cuda, 2, ho, ho, cout, kh, stride, dil, epilogue)
    if layout == "halo":
        buf = build_halo_input(x, kh=kh, kw=kh, stride=stride, dilation=dil,
                               vk=vk)
        kernel, plain = vsconv_halo_kernel, vsconv_plain
    else:
        buf = build_row_tap_stack(x, kh=kh, kw=kh, stride=stride,
                                  dilation=dil)
        kernel, plain = vsconv_stack_kernel, vsconv_stack_plain
    stem = use_stem_body(cin, vk, groups, kh, kh, vn, stride=stride,
                         dilation=dil)
    assert stem == (cin in (8, 16))
    before, before_stem = kernel.launches, kernel.stem_launches
    y = kernel(buf, vs, groups=groups, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert kernel.stem_launches == before_stem + stem
    assert y.shape == (2, ho, ho, cout)
    assert _rel(y, plain(buf, vs, groups=groups, **kw)) <= RTOL


def _taps(rng, kh, c, vc, density, device):
    """A (kh*kh, C) depthwise tap matrix, vk 1, vc-channel strips."""
    return _sparse(rng, kh * kh, c, 1, vc, density, device)


@pytest.mark.parametrize("size,c,stride,dil,vc,zero", [
    (16, 32, 1, 1, 32, False),     # dw1-like: vc 32
    (16, 64, 2, 1, 64, False),     # dw2-like: stride 2, asymmetric pads
    (7, 512, 1, 1, 128, False),    # dw7-like: 4 strips of 128
    (14, 512, 2, 1, 128, False),   # dw12-like: 14 -> 7
    (9, 48, 1, 2, 48, False),      # dilated, vc 48 (not a divisor of 256)
    (7, 1024, 1, 1, 128, False),   # dw13: 7 px, 8 strips of 128
    (10, 30, 1, 1, 30, False),     # vc 30: 4-byte copies
    (12, 64, 1, 1, 64, True),      # all zeros: the skip
])
@pytest.mark.parametrize("layout", ["halo", "stack"])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("tiles", ["rule", "large"])
def test_dw_kernels_match_plain(cuda, monkeypatch, size, c, stride, dil, vc,
                                zero, layout, epilogue, tiles):
    """``tiles="large"`` lifts the tile rule's minimum block count, so
    these small images run the tiles the rule gives the 224 px layers
    (8 x 16 at vc 32, a whole 7 px image) rather than tiles cut down to
    fill the card."""
    if tiles == "large":
        monkeypatch.setattr(TD, "DW_MIN_BLOCKS", 1)
        # the rule is cached per shape: run it uncached, with the new bound
        monkeypatch.setattr(TD, "dw_tile", TD.dw_tile.__wrapped__)
    rng = np.random.default_rng(size + c + stride)
    vs = _taps(rng, 3, c, vc, 0.5, cuda)
    x = _relu_input(rng, (2, size, size, c), cuda, zero)
    ho = -(-size // stride)
    kw = _conv_kwargs(cuda, 2, ho, ho, c, 3, stride, dil, epilogue)
    if layout == "halo":
        buf = build_halo_input(x, kh=3, kw=3, stride=stride, dilation=dil,
                               vk=vc)
        kernel, plain = vsconv_dw_halo_kernel, vsconv_dw_plain
    else:
        buf = build_row_tap_stack(x, kh=3, kw=3, stride=stride, dilation=dil)
        kernel, plain = vsconv_dw_stack_kernel, vsconv_dw_stack_plain
    before = kernel.launches
    y = kernel(buf, vs, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert y.shape == (2, ho, ho, c)
    assert _rel(y, plain(buf, vs, **kw)) <= RTOL


@pytest.mark.parametrize("impl", ["halo", "stack"])
def test_dw_kernel_decodes_taps_in_any_order(cuda, impl):
    """idx[j, s] is the bare tap id, decoded as given: reversing every
    strip's tap order changes nothing but the f32 summation order."""
    rng = np.random.default_rng(7)
    vs = _taps(rng, 3, 256, 128, 0.5, cuda)
    rev = VectorSparse(vs.vals.flip(1).contiguous(),
                       vs.idx.flip(1).contiguous(), vs.shape)
    x = _relu_input(rng, (2, 10, 10, 256), cuda)
    y = ops.vsconv(x, vs, groups=256, stride=2, impl=impl)
    assert _rel(ops.vsconv(x, rev, groups=256, stride=2, impl=impl), y) \
        <= RTOL


@pytest.mark.parametrize("impl,per_forward", [
    ("pallas", {"halo": 1, "dw_halo": 13, "vsmm": 14}),
    ("pallas-stack", {"stack": 1, "dw_stack": 13, "vsmm": 14}),
])
def test_mobilenet_kernels_match_plain(cuda, impl, per_forward):
    """MobileNetV1 at 32 px through each layout: the stem through the full
    conv kernel, 13 depthwise convs through the tap kernel, 13 pointwise
    convs and the head through vsmm; agrees with the plain path."""
    counters = {"halo": vsconv_halo_kernel, "stack": vsconv_stack_kernel,
                "dw_halo": vsconv_dw_halo_kernel,
                "dw_stack": vsconv_dw_stack_kernel, "vsmm": vsmm_kernel}
    net = TG.build_mobilenet_v1(10)
    params = init_params(net.schema(), 0, device=cuda)
    sparse, _ = TG.sparsify(net, params, 0.5)
    x = torch.randn(2, 32, 32, 3, device=cuda)
    for k in counters.values():
        k.launches = 0
    vsconv_halo_kernel.stem_launches = vsconv_stack_kernel.stem_launches = 0
    y = TG.net_apply(net, params, x, sparse=sparse, impl=impl)
    launched = {name: k.launches for name, k in counters.items()
                if k.launches}
    assert launched == per_forward
    assert vsconv_halo_kernel.stem_launches + \
        vsconv_stack_kernel.stem_launches == 1
    y_plain = TG.net_apply(net, params, x, sparse=sparse, impl="plain")
    assert y.shape == (2, 10)
    assert _rel(y, y_plain) <= RTOL


def test_resnet18_stack_kernels_match_plain(cuda):
    net = TG.build_resnet18(10)
    params = init_params(net.schema(), 0, device=cuda)
    sparse, _ = TG.sparsify(net, params, 0.5)
    x = torch.randn(2, 32, 32, 3, device=cuda)
    vsmm_kernel.launches = vsconv_stack_kernel.launches = 0
    vsconv_stack_kernel.stem_launches = 0
    y = TG.net_apply(net, params, x, sparse=sparse, impl="pallas-stack")
    assert (vsconv_stack_kernel.launches, vsmm_kernel.launches) == (17, 4)
    assert vsconv_stack_kernel.stem_launches == 1
    assert _rel(y, TG.net_apply(net, params, x, sparse=sparse,
                                impl="plain")) <= RTOL


FLASH_CASES = [  # bh, tq, tk, hd, causal, window, q_offset
    (4, 512, 512, 128, True, None, 0),     # Qwen's prefill shape, 4 heads
    (2, 528, 528, 128, True, None, 0),     # a backfill length
    (2, 300, 300, 240, True, 64, 0),       # Gemma-3's head dim, a window
    (2, 64, 576, 128, True, None, 512),    # q_offset: 64 queries at the end
    (3, 200, 200, 80, False, None, 0),     # non-causal, HuBERT's head dim
    (2, 33, 33, 32, True, None, 0),        # odd length
    (2, 65, 97, 32, False, 20, 0),         # window without causal
    (2, 300, 300, 64, True, None, 0),      # hd 64
    (2, 200, 200, 256, True, None, 0),     # the largest head dim
    (3, 70, 70, 20, True, None, 0),        # hd 20: padded to 32 in bf16
    (4, 1, 40, 128, True, None, 39),       # one query (Tq 1) at the end
    (2, 50, 37, 64, False, None, 0),       # Tk < 64: one ragged kv tile
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    bh, tq, tk, hd, causal, window, q_offset = case
    gen = torch.Generator().manual_seed(tq + hd)
    q, k, v = (torch.randn(bh, t, hd, generator=gen).to(cuda, dtype)
               for t in (tq, tk, tk))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = TF.flash_fwd_kernel.launches
    y = TF.flash_fwd_kernel(q, k, v, **kw)
    assert TF.flash_fwd_kernel.launches == before + 1
    torch.cuda.synchronize()
    y_plain = TF.flash_fwd_plain(q, k, v, **kw)
    assert y.dtype == dtype and y.shape == (bh, tq, hd)
    assert torch.isfinite(y.float()).all()
    tol = RTOL if dtype == torch.float32 else 1e-2
    assert _rel(y.float(), y_plain.float()) <= tol


def test_flash_kernel_bf16_is_bit_deterministic(cuda):
    """No split over keys, no atomics: two launches give equal bits."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(8, 512, 128, generator=gen).to(cuda,
                                                          torch.bfloat16)
               for _ in range(3))
    assert TF.kernel_body(q.dtype) == "mma"
    y1 = TF.flash_fwd_kernel(q, k, v)
    y2 = TF.flash_fwd_kernel(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("hd", [128, 20])
@pytest.mark.parametrize("offset", [4, 2, 1])  # bf16 elements: 8, 4, 2 B
def test_flash_kernel_bf16_takes_unaligned_storage(cuda, hd, offset):
    """A contiguous slice whose data_ptr is not 16-byte aligned takes a
    narrower copy inside the kernel, never the plain version."""
    bh, t = 3, 100
    gen = torch.Generator().manual_seed(hd + offset)
    qkv = []
    for _ in range(3):
        buf = torch.randn(offset + bh * t * hd, generator=gen).to(
            cuda, torch.bfloat16)
        qkv.append(buf[offset:].view(bh, t, hd))
    q, k, v = qkv
    assert q.is_contiguous() and q.data_ptr() % 16 == 2 * offset % 16
    before = TF.flash_fwd_kernel.launches
    y = TF.flash_fwd_kernel(q, k, v)
    assert TF.flash_fwd_kernel.launches == before + 1
    torch.cuda.synchronize()
    y_plain = TF.flash_fwd_plain(q, k, v)
    assert _rel(y.float(), y_plain.float()) <= 1e-2


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.randn(2, 16, 64, device=cuda)
    before = TF.flash_fwd_kernel.launches
    for bad in (dict(q=q.half(), k=q.half(), v=q.half()),
                dict(q=q.double(), k=q.double(), v=q.double()),
                dict(q=q, k=q.to(torch.bfloat16), v=q),
                dict(q=q, k=q.transpose(1, 2).contiguous().transpose(1, 2),
                     v=q)):
        with pytest.raises(ValueError):
            TF.flash_fwd_kernel(**bad)
    wide = torch.randn(1, 8, 260, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        TF.flash_fwd_kernel(wide, wide, wide)
    assert TF.flash_fwd_kernel.launches == before


def test_reduced_qwen_served_through_the_kernel_equals_plain(cuda):
    """Reduced Qwen (f32) served on the card: every prefill runs the flash
    kernel once per layer, decode steps run none, and the token streams
    equal the same serve with the plain version in the kernel's place."""
    cfg = get_config("qwen1.5-4b").reduce()
    srv = TS.Server(cfg, batch=2, capacity=64, device=cuda)
    rng = np.random.default_rng(0)
    traffic = [(i, rng.integers(0, cfg.vocab, int(rng.integers(18, 31)),
                                dtype=np.int32), int(rng.integers(3, 10)))
               for i in range(4)]

    def serve():
        reqs = [TS.Request(rid=r, prompt=p, max_new=m)
                for r, p, m in traffic]
        return reqs, srv.serve(reqs)

    TF.flash_fwd_kernel.launches = 0
    got, stats = serve()
    prefills = len(stats) + sum(s["backfills"] for s in stats)
    assert sum(s["backfills"] for s in stats) >= 1
    assert TF.flash_fwd_kernel.launches == cfg.total_layers * prefills
    with mock.patch.object(TA, "flash_fwd_kernel", TF.flash_fwd_plain):
        ref, _ = serve()
    assert TF.flash_fwd_kernel.launches == cfg.total_layers * prefills
    assert [r.out for r in got] == [r.out for r in ref]
    assert [len(r.out) for r in got] == [m for _, _, m in traffic]


def test_sampling_on_the_card_is_reproducible_and_keeps_greedy(cuda):
    """The per-slot sampler on CUDA logits: a hot request re-served emits
    the same tokens; its greedy neighbour emits what it emits alone."""
    cfg = get_config("qwen1.5-4b").reduce()
    srv = TS.Server(cfg, batch=2, capacity=64, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 6, dtype=np.int32)
               for _ in range(2)]

    def serve(temps):
        reqs = [TS.Request(rid=100 + i, prompt=p, max_new=8, temperature=t)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        srv.serve(reqs)
        return [r.out for r in reqs]

    greedy = serve([0.0, 0.0])
    mixed = serve([0.0, 5.0])
    again = serve([0.0, 5.0])
    assert mixed == again
    assert mixed[0] == greedy[0]
    assert mixed[1] != greedy[1]


# --------------------------------------------------------------------------
# The int8 branches: bit for bit against the plain versions on the card
# --------------------------------------------------------------------------

def _int8_sparse(rng, k, n, vk, vn, density, device, cb=None):
    """An int8-encoded weight as `sparsify` makes it (cin-major with ``cb``
    cin tiles) and its per-column scales, on ``device``."""
    w = rng.standard_normal((k, n)).astype(np.float32)
    if density < 1:
        w, mask = prune_vectors_balanced(w, density, vk, vn)
    else:
        mask = np.ones((k // vk, n // vn), bool)
    s = TG.weight_scales(w)
    vs = from_mask(torch.as_tensor(TG.quantize_weights_int8(w, s),
                                   device=device), mask, vk, vn)
    if cb is not None:
        vs = conv_cin_major(vs, cb)
    return vs, torch.as_tensor(s, device=device)


def _int8_input(rng, shape, device, zero=False):
    """Quantized post-ReLU-like activations (zero runs for the input-side
    skip) and their scale, quantized on the card."""
    return TG.quantize_activations_int8(
        _relu_input(rng, shape, device, zero=zero))


def _int8_kwargs(cuda, scale, cout, out_shape, epilogue):
    kw = dict(scale=scale)
    if epilogue:
        kw.update(bias=torch.randn(cout, device=cuda), fuse_relu=True,
                  residual=torch.randn(*out_shape, device=cuda))
    return kw


def _assert_bit_equal(y, ref):
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    assert torch.equal(y, ref), float((y - ref).abs().max())


@pytest.mark.parametrize("m,k,n,vk,vn,density,zero", [
    (37, 64, 20, 8, 10, 0.5, False),     # ragged M, a 10-wide strip
    (300, 256, 256, 32, 128, 0.25, False),
    (8, 512, 1024, 32, 128, 0.235, False),  # the 224 px FC head at batch 8
    (33, 36, 12, 6, 12, 0.5, False),     # vk 6: byte loads, no word reads
    (40, 64, 64, 32, 64, 0.5, True),     # every tile skipped
])
@pytest.mark.parametrize("epilogue", [False, True])
def test_vsmm_int8_kernel_bit_equal_to_plain(cuda, m, k, n, vk, vn, density,
                                             zero, epilogue):
    rng = np.random.default_rng(m + k)
    vs, s_w = _int8_sparse(rng, k, n, vk, vn, density, cuda)
    xq, sx = _int8_input(rng, (m, k), cuda, zero=zero)
    kw = _int8_kwargs(cuda, sx * s_w, n, (m, n), epilogue)
    before = (vsmm_kernel.launches, vsmm_kernel.int8_launches)
    y = vsmm_kernel(xq, vs, **kw)
    torch.cuda.synchronize()
    assert (vsmm_kernel.launches, vsmm_kernel.int8_launches) == (
        before[0] + 1, before[1] + 1)
    _assert_bit_equal(y, vsmm_plain(xq, vs, **kw))


def test_vsmm_int8_kernel_reads_no_word_past_a_row(cuda):
    """x starting at an odd byte (vk 32): the kernel takes byte loads,
    and a row's last tile ends at the buffer's last byte."""
    rng = np.random.default_rng(9)
    vs, s_w = _int8_sparse(rng, 64, 64, 32, 64, 0.5, cuda)
    xq, sx = _int8_input(rng, (17, 64), cuda)
    buf = torch.empty(17 * 64 + 1, dtype=torch.int8, device=cuda)
    x_odd = buf[1:].view(17, 64)
    x_odd.copy_(xq)
    y = vsmm_kernel(x_odd, vs, scale=sx * s_w)
    torch.cuda.synchronize()
    _assert_bit_equal(y, vsmm_plain(xq, vs, scale=sx * s_w))


def test_vsmm_int8_kernel_keeps_stored_step_order(cuda):
    """±127 weights over 64 stored steps: the f32 sum passes 2^24, so
    only the stored order of the f32 adds gives the plain version's
    bits."""
    rng = np.random.default_rng(3)
    m, k, n, vk, vn = 16, 2048, 128, 32, 128
    wq = np.where(rng.random((k, n)) < 0.9, 127, -127).astype(np.int8)
    xq = np.where(rng.random((m, k)) < 0.5, 127, 126).astype(np.int8)
    vs = from_mask(torch.as_tensor(wq, device=cuda),
                   np.ones((k // vk, n // vn), bool), vk, vn)
    x = torch.as_tensor(xq, device=cuda)
    scale = torch.ones(n, device=cuda)
    y = vsmm_kernel(x, vs, scale=scale)
    torch.cuda.synchronize()
    _assert_bit_equal(y, vsmm_plain(x, vs, scale=scale))
    assert float(y.abs().max()) > 2 ** 24


@pytest.mark.parametrize("size,cin,cout,kh,stride,groups,vk,vn,density", [
    (32, 8, 64, 7, 2, 1, 8, 64, 1.0),     # the stem: the int8 stem body
    (16, 64, 64, 3, 1, 1, 32, 64, 0.5),
    (16, 64, 128, 3, 2, 1, 32, 128, 0.25),
    (3, 128, 128, 3, 1, 1, 32, 128, 0.5),  # Hout < 4
    (12, 64, 64, 3, 1, 4, 16, 16, 0.5),    # grouped
    (11, 12, 12, 3, 2, 1, 6, 6, 0.5),      # vk 6: byte loads
])
@pytest.mark.parametrize("epilogue", [False, True])
def test_vsconv_halo_int8_kernel_bit_equal_to_plain(
        cuda, size, cin, cout, kh, stride, groups, vk, vn, density,
        epilogue):
    rng = np.random.default_rng(size + cin + kh)
    cin_g = cin // groups
    vs, s_w = _int8_sparse(rng, kh * kh * cin_g, cout, vk, vn, density,
                           cuda, cb=cin_g // vk)
    xq, sx = _int8_input(rng, (2, size, size, cin), cuda)
    xh = build_halo_input(xq, kh=kh, kw=kh, stride=stride, vk=vk)
    ho = -(-size // stride)
    kw = dict(w_out=ho, kh=kh, kw=kh, stride=stride, groups=groups,
              **_int8_kwargs(cuda, sx * s_w, cout, (2, ho, ho, cout),
                             epilogue))
    before = (vsconv_halo_kernel.launches, vsconv_halo_kernel.int8_launches,
              vsconv_halo_kernel.stem_launches)
    stem = use_stem_body(cin, vk, groups, kh, kh, vn, stride=stride,
                         int8=True)
    assert stem == (cin == 8)
    y = vsconv_halo_kernel(xh, vs, **kw)
    torch.cuda.synchronize()
    assert (vsconv_halo_kernel.launches, vsconv_halo_kernel.int8_launches,
            vsconv_halo_kernel.stem_launches) == (
        before[0] + 1, before[1] + 1, before[2] + stem)
    _assert_bit_equal(y, vsconv_plain(xh, vs, **kw))


@pytest.mark.parametrize("size,c,stride,vc", [
    (112, 32, 1, 32),   # MobileNetV1's dw1 at 224 px
    (40, 64, 2, 64),
    (14, 512, 2, 128),  # dw12
    (9, 12, 1, 12),     # vc 12: 4-byte copies through the runtime-vc body
    (9, 6, 2, 6),       # vc 6: one-byte loads
])
@pytest.mark.parametrize("epilogue", [False, True])
def test_dw_halo_int8_kernel_bit_equal_to_plain(cuda, size, c, stride, vc,
                                                epilogue):
    rng = np.random.default_rng(size + c)
    vs, s_w = _int8_sparse(rng, 9, c, 1, vc, 0.5, cuda)
    xq, sx = _int8_input(rng, (2, size, size, c), cuda)
    xh = build_halo_input(xq, kh=3, kw=3, stride=stride, vk=vc)
    ho = -(-size // stride)
    kw = dict(w_out=ho, kh=3, kw=3, stride=stride,
              **_int8_kwargs(cuda, sx * s_w, c, (2, ho, ho, c), epilogue))
    before = vsconv_dw_halo_kernel.int8_launches
    y = vsconv_dw_halo_kernel(xh, vs, **kw)
    torch.cuda.synchronize()
    assert vsconv_dw_halo_kernel.int8_launches == before + 1
    _assert_bit_equal(y, vsconv_dw_plain(xh, vs, **kw))


def test_int8_quantizer_on_the_card_equals_the_cpu(cuda):
    """`quantize_activations_int8` on the card gives the CPU's codes and
    scale (exact powers of two, .5 ties, an all-zero tensor)."""
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((4, 9, 9, 16)).astype(np.float32),
          np.zeros((2, 3), np.float32)]
    x = np.clip(rng.standard_normal((2, 8, 8)), -1, 1).astype(np.float32)
    x[0, 0, 0] = 127.0 * 2.0 ** -4
    x[1] = (rng.integers(-126, 126, (8, 8)) + 0.5) * 2.0 ** -4
    xs.append(x)
    for a in xs:
        qc, sc = TG.quantize_activations_int8(torch.from_numpy(a))
        qg, sg = TG.quantize_activations_int8(torch.from_numpy(a).to(cuda))
        assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)


def test_int8_stack_kernels_raise_not_implemented(cuda):
    """The stack kernels' int8 branches are ported: int8 CUDA stacks
    launch them (no NotImplementedError), counted on ``int8_launches``;
    int8 operands without a dequant scale still raise."""
    rng = np.random.default_rng(8)
    vs, s_w = _int8_sparse(rng, 9 * 64, 64, 32, 64, 0.5, cuda, cb=2)
    xq, sx = _int8_input(rng, (1, 8, 8, 64), cuda)
    xt = build_row_tap_stack(xq, kh=3, kw=3)
    before = (vsconv_stack_kernel.int8_launches,
              vsconv_dw_stack_kernel.int8_launches)
    y = vsconv_stack_kernel(xt, vs, w_out=8, scale=sx * s_w)
    dvs, ds = _int8_sparse(rng, 9, 64, 1, 64, 0.5, cuda)
    yd = vsconv_dw_stack_kernel(xt, dvs, w_out=8, scale=sx * ds)
    torch.cuda.synchronize()
    assert (vsconv_stack_kernel.int8_launches,
            vsconv_dw_stack_kernel.int8_launches) == (before[0] + 1,
                                                      before[1] + 1)
    _assert_bit_equal(y, vsconv_stack_plain(xt, vs, w_out=8,
                                            scale=sx * s_w))
    _assert_bit_equal(yd, vsconv_dw_stack_plain(xt, dvs, w_out=8,
                                                scale=sx * ds))
    with pytest.raises(ValueError, match="scale"):
        vsmm_kernel(xq.reshape(64, 64), _int8_sparse(
            rng, 64, 64, 32, 64, 0.5, cuda)[0])
    with pytest.raises(ValueError, match="scale"):
        vsconv_stack_kernel(xt, vs, w_out=8)


@pytest.mark.parametrize("size,cin,cout,kh,stride,groups,vk,vn,density", [
    (32, 8, 64, 7, 2, 1, 8, 64, 1.0),     # ResNet-18's stem: 14 planes
    (32, 8, 64, 3, 1, 1, 8, 64, 1.0),     # VGG-16's conv1 (stem body)
    (16, 64, 64, 3, 1, 1, 32, 64, 0.5),
    (16, 64, 128, 3, 2, 1, 32, 128, 0.25),
    (3, 128, 128, 3, 1, 1, 32, 128, 0.5),  # Hout < 4
    (12, 64, 64, 3, 1, 4, 16, 16, 0.5),    # grouped
    (11, 12, 12, 3, 2, 1, 6, 6, 0.5),      # vk 6: byte loads
])
@pytest.mark.parametrize("epilogue", [False, True])
def test_vsconv_stack_int8_kernel_bit_equal_to_plain(
        cuda, size, cin, cout, kh, stride, groups, vk, vn, density,
        epilogue):
    rng = np.random.default_rng(size + cin + kh + 1)
    cin_g = cin // groups
    vs, s_w = _int8_sparse(rng, kh * kh * cin_g, cout, vk, vn, density,
                           cuda, cb=cin_g // vk)
    xq, sx = _int8_input(rng, (2, size, size, cin), cuda)
    xt = build_row_tap_stack(xq, kh=kh, kw=kh, stride=stride)
    ho = -(-size // stride)
    kw = dict(w_out=ho, kh=kh, kw=kh, stride=stride, groups=groups,
              **_int8_kwargs(cuda, sx * s_w, cout, (2, ho, ho, cout),
                             epilogue))
    k = vsconv_stack_kernel
    before = (k.launches, k.int8_launches, k.stem_launches)
    stem = use_stem_body(cin, vk, groups, kh, kh, vn, stride=stride,
                         int8=True)
    assert stem == (cin == 8)
    y = k(xt, vs, **kw)
    torch.cuda.synchronize()
    assert (k.launches, k.int8_launches, k.stem_launches) == (
        before[0] + 1, before[1] + 1, before[2] + stem)
    _assert_bit_equal(y, vsconv_stack_plain(xt, vs, **kw))


def test_vsconv_stack_int8_kernel_keeps_stored_step_order(cuda):
    """±127 weights over 72 stored steps (3x3, 256 channels in tiles of
    32) against codes of 127 and 126: the f32 sum passes 2^24, so only
    the stored order of the f32 adds gives the plain version's bits."""
    rng = np.random.default_rng(11)
    k, n, vk, vn = 9 * 256, 128, 32, 128
    wq = np.where(rng.random((k, n)) < 0.9, 127, -127).astype(np.int8)
    vs = conv_cin_major(from_mask(torch.as_tensor(wq, device=cuda),
                                  np.ones((k // vk, n // vn), bool), vk, vn),
                        256 // vk)
    xq = torch.as_tensor(np.where(rng.random((1, 6, 6, 256)) < 0.5, 127,
                                  126).astype(np.int8), device=cuda)
    xt = build_row_tap_stack(xq, kh=3, kw=3)
    scale = torch.ones(n, device=cuda)
    y = vsconv_stack_kernel(xt, vs, w_out=6, scale=scale)
    torch.cuda.synchronize()
    _assert_bit_equal(y, vsconv_stack_plain(xt, vs, w_out=6, scale=scale))
    assert float(y.abs().max()) > 2 ** 24


@pytest.mark.parametrize("size,c,stride,vc", [
    (112, 32, 1, 32),   # MobileNetV1's dw1 at 224 px
    (40, 64, 2, 64),
    (14, 512, 2, 128),  # dw12
    (9, 12, 1, 12),     # vc 12: 4-byte copies through the runtime-vc body
    (9, 6, 2, 6),       # vc 6: one-byte loads
])
@pytest.mark.parametrize("epilogue", [False, True])
def test_dw_stack_int8_kernel_bit_equal_to_plain(cuda, size, c, stride, vc,
                                                 epilogue):
    rng = np.random.default_rng(size + c + 1)
    vs, s_w = _int8_sparse(rng, 9, c, 1, vc, 0.5, cuda)
    xq, sx = _int8_input(rng, (2, size, size, c), cuda)
    xt = build_row_tap_stack(xq, kh=3, kw=3, stride=stride)
    ho = -(-size // stride)
    kw = dict(w_out=ho, kh=3, kw=3, stride=stride,
              **_int8_kwargs(cuda, sx * s_w, c, (2, ho, ho, c), epilogue))
    before = vsconv_dw_stack_kernel.int8_launches
    y = vsconv_dw_stack_kernel(xt, vs, **kw)
    torch.cuda.synchronize()
    assert vsconv_dw_stack_kernel.int8_launches == before + 1
    _assert_bit_equal(y, vsconv_dw_stack_plain(xt, vs, **kw))


# --------------------------------------------------------------------------
# skip_zero_inputs=False: the same bits as the skip on, for every entry
# --------------------------------------------------------------------------

SKIP_CASES = [  # kernel, dtype
    ("vsmm", "f32"), ("vsmm", "int8"),
    ("halo", "f32"), ("halo", "int8"), ("halo_stem", "f32"),
    ("halo_stem", "int8"),
    ("stack", "f32"), ("stack", "int8"), ("stack_stem", "f32"),
    ("stack_stem", "int8"),
    ("dw_halo", "f32"), ("dw_halo", "int8"),
    ("dw_stack", "f32"), ("dw_stack", "int8"),
]


def _skip_case(rng, kernel, dtype, cuda):
    """(wrapper, plain version, buffer, weight, kwargs): a post-ReLU input
    whose first quarter of channels is zero (whole zero tiles) and whose
    first image is all zero (every tile of its blocks zero)."""
    int8 = dtype == "int8"
    stem = kernel.endswith("_stem")
    if kernel == "vsmm":
        x = _relu_input(rng, (64, 128), cuda)
        x[:32] = 0
        k, n, vk, vn, cb, shape = 128, 128, 32, 128, None, (64, 128)
    elif kernel.startswith("dw_"):
        x = _relu_input(rng, (2, 12, 12, 64), cuda)
        k, n, vk, vn, cb, shape = 9, 64, 1, 64, None, (2, 12, 12, 64)
    else:
        cin, vk, vn = (8, 8, 64) if stem else (64, 32, 64)
        x = _relu_input(rng, (2, 16, 16, cin), cuda)
        if stem:
            x[..., 3:] = 0  # the stem's cin padding
        k, n, cb, shape = 9 * cin, 64, cin // vk, (2, 16, 16, 64)
    if kernel != "vsmm":
        x[0] = 0
    kw = {}
    if int8:
        vs, s_w = _int8_sparse(rng, k, n, vk, vn, 0.5, cuda, cb=cb)
        x, sx = TG.quantize_activations_int8(x)
        kw["scale"] = sx * s_w
    else:
        vs = _sparse(rng, k, n, vk, vn, 0.5, cuda)
        if cb is not None:
            vs = conv_cin_major(vs, cb)
    kw.update(bias=torch.randn(n, device=cuda), fuse_relu=True,
              residual=torch.randn(*shape, device=cuda))
    if kernel == "vsmm":
        return vsmm_kernel, vsmm_plain, x, vs, kw
    kw.update(w_out=shape[2], kh=3, kw=3)
    if kernel.startswith("halo"):
        buf = build_halo_input(x, kh=3, kw=3, vk=vk)
        return vsconv_halo_kernel, vsconv_plain, buf, vs, kw
    if kernel == "dw_halo":
        buf = build_halo_input(x, kh=3, kw=3, vk=vn)
        return vsconv_dw_halo_kernel, vsconv_dw_plain, buf, vs, kw
    buf = build_row_tap_stack(x, kh=3, kw=3)
    if kernel == "dw_stack":
        return vsconv_dw_stack_kernel, vsconv_dw_stack_plain, buf, vs, kw
    return vsconv_stack_kernel, vsconv_stack_plain, buf, vs, kw


@pytest.mark.parametrize("kernel,dtype", SKIP_CASES)
def test_skip_off_bit_equal_to_skip_on(cuda, kernel, dtype):
    """``skip_zero_inputs=False`` runs every stored step's MAC (no vote);
    a skipped step adds exact zeros, so the output has the skip-on bits,
    and equals the plain version (bit for bit in int8, 1e-5 in f32)."""
    rng = np.random.default_rng(len(kernel) + len(dtype))
    wrapper, plain, buf, vs, kw = _skip_case(rng, kernel, dtype, cuda)
    before = (wrapper.launches, getattr(wrapper, "stem_launches", 0))
    y_on = wrapper(buf, vs, **kw)
    y_off = wrapper(buf, vs, skip_zero_inputs=False, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before[0] + 2
    if kernel.endswith("_stem"):
        assert wrapper.stem_launches == before[1] + 2
    assert torch.equal(y_on, y_off)
    ref = plain(buf, vs, skip_zero_inputs=False, **kw)
    if dtype == "int8":
        _assert_bit_equal(y_off, ref)
    else:
        assert _rel(y_off, ref) <= RTOL


def test_dispatch_passes_skip_flag_through(cuda):
    """`ops.vsmm`, `ops.vsconv` (both layouts, depthwise too) and
    `sparse_ops.vs_matmul` with the skip off give the skip-on bits."""
    from repro_torch.core.sparse_ops import vs_matmul
    rng = np.random.default_rng(12)
    x = _relu_input(rng, (2, 10, 10, 64), cuda)
    vs = conv_cin_major(_sparse(rng, 9 * 64, 64, 32, 64, 0.5, cuda), 2)
    dvs = _taps(rng, 3, 64, 64, 0.5, cuda)
    for impl in ("halo", "stack"):
        for w, groups in ((vs, 1), (dvs, 64)):
            on = ops.vsconv(x, w, groups=groups, impl=impl)
            off = ops.vsconv(x, w, groups=groups, impl=impl,
                             skip_zero_inputs=False)
            assert torch.equal(on, off)
    mvs = _sparse(rng, 64, 128, 32, 128, 0.5, cuda)
    x2 = x.reshape(-1, 64)
    assert torch.equal(ops.vsmm(x2, mvs),
                       ops.vsmm(x2, mvs, skip_zero_inputs=False))
    assert torch.equal(vs_matmul(x2, mvs, impl="pallas"),
                       vs_matmul(x2, mvs, impl="pallas",
                                 skip_zero_inputs=False))


# --------------------------------------------------------------------------
# VGG-16's new shapes, and the int8 stack serving paths
# --------------------------------------------------------------------------

def test_vgg16_conv1_takes_the_stem_body(cuda):
    """VGG-16's conv1 at 224 px (3x3/s1, cin 3 -> 8, vk 8, vn 64): the
    stem body's first stride-1 use, in both layouts, within 1e-5 of
    plain."""
    assert use_stem_body(8, 8, 1, 3, 3, 64, stride=1)
    rng = np.random.default_rng(13)
    vs = conv_cin_major(_sparse(rng, 72, 64, 8, 64, 0.235, cuda), 1)
    x = _relu_input(rng, (2, 224, 224, 8), cuda)
    x[..., 3:] = 0
    kw = dict(w_out=224, kh=3, kw=3, bias=torch.randn(64, device=cuda),
              fuse_relu=True)
    for kernel, plain, buf in (
            (vsconv_halo_kernel, vsconv_plain,
             build_halo_input(x, kh=3, kw=3, vk=8)),
            (vsconv_stack_kernel, vsconv_stack_plain,
             build_row_tap_stack(x, kh=3, kw=3))):
        before = kernel.stem_launches
        y = kernel(buf, vs, **kw)
        torch.cuda.synchronize()
        assert kernel.stem_launches == before + 1
        assert _rel(y, plain(buf, vs, **kw)) <= RTOL


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_vgg16_fc1_matches_plain(cuda, dtype):
    """fc1 at 224 px: 25088 -> 4096 at 8 rows (kb 784, 32 strips, density
    0.235); int8 bit for bit."""
    rng = np.random.default_rng(14)
    x = torch.rand(8, 25088, device=cuda)
    kw = dict(bias=torch.randn(4096, device=cuda), fuse_relu=True)
    if dtype == "int8":
        vs, s_w = _int8_sparse(rng, 25088, 4096, 32, 128, 0.235, cuda)
        x, sx = TG.quantize_activations_int8(x)
        kw["scale"] = sx * s_w
    else:
        vs = _sparse(rng, 25088, 4096, 32, 128, 0.235, cuda)
    y = vsmm_kernel(x, vs, **kw)
    torch.cuda.synchronize()
    ref = vsmm_plain(x, vs, **kw)
    if dtype == "int8":
        _assert_bit_equal(y, ref)
    else:
        assert _rel(y, ref) <= RTOL


@pytest.mark.parametrize("arch,per_wave", [
    ("vscnn-vgg16", {"stack": 13, "vsmm": 3}),
    ("vscnn-resnet18", {"stack": 17, "vsmm": 4}),
    ("vscnn-mobilenet-v1", {"stack": 1, "dw_stack": 13, "vsmm": 14}),
])
def test_int8_stack_served_wave_bit_equal_to_plain(cuda, arch, per_wave):
    """One int8 wave of 4 images at 32 px through `CNNServer(dtype="int8",
    impl="pallas-stack")`: every conv through an int8 stack kernel (the
    stem through its int8 stem body), every FC and 1x1 through vsmm's int8
    branch, logits bit-equal to `net_apply(impl="plain")` on the card.
    The wave is its bucket's first: the device runs the forward twice (the
    CUDA graph's eager warm-up and its first replay), and both count."""
    counters = {"stack": vsconv_stack_kernel,
                "dw_stack": vsconv_dw_stack_kernel, "vsmm": vsmm_kernel,
                "halo": vsconv_halo_kernel, "dw_halo": vsconv_dw_halo_kernel}
    srv = TS.CNNServer(get_config(arch).reduce(), batch=4, density=0.5,
                       seed=0, dtype="int8", impl="pallas-stack",
                       device=cuda)
    rng = np.random.default_rng(3)
    imgs = [rng.standard_normal((32, 32, 3)).astype(np.float32)
            for _ in range(4)]
    reqs = [TS.ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    for k in counters.values():
        k.launches = k.int8_launches = 0
    vsconv_stack_kernel.stem_launches = 0
    srv.serve(reqs)
    torch.cuda.synchronize()
    twice = {n: 2 * v for n, v in per_wave.items()}
    assert {n: k.launches for n, k in counters.items()
            if k.launches} == twice
    assert {n: k.int8_launches for n, k in counters.items()
            if k.int8_launches} == twice
    assert vsconv_stack_kernel.stem_launches == 2
    with torch.inference_mode():
        ref = TG.net_apply(srv.net, srv.params,
                           torch.from_numpy(np.stack(imgs)).to(cuda),
                           sparse=srv.sparse, impl="plain").cpu().numpy()
    for i, r in enumerate(reqs):
        assert r.outcome.status == "delivered"
        assert np.isfinite(r.logits).all()
        np.testing.assert_array_equal(r.logits, ref[i])


@pytest.mark.parametrize("arch,per_wave", [
    ("vscnn-resnet18", {"halo": 17, "vsmm": 4}),
    ("vscnn-mobilenet-v1", {"halo": 1, "dw_halo": 13, "vsmm": 14}),
])
def test_int8_served_wave_bit_equal_to_plain(cuda, arch, per_wave):
    """One int8 wave of 4 images at 32 px through `CNNServer(dtype=
    "int8")`: every conv and FC through an int8 kernel branch (the stem
    through the int8 stem body), logits bit-equal to
    `net_apply(impl="plain")` on the card.  As the bucket's first wave it
    runs, and counts, the forward twice (warm-up and first replay)."""
    counters = {"halo": vsconv_halo_kernel, "dw_halo": vsconv_dw_halo_kernel,
                "vsmm": vsmm_kernel}
    srv = TS.CNNServer(get_config(arch).reduce(), batch=4, density=0.5,
                       seed=0, dtype="int8", device=cuda)
    rng = np.random.default_rng(2)
    imgs = [rng.standard_normal((32, 32, 3)).astype(np.float32)
            for _ in range(4)]
    reqs = [TS.ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    for k in counters.values():
        k.launches = k.int8_launches = 0
    vsconv_halo_kernel.stem_launches = 0
    srv.serve(reqs)
    torch.cuda.synchronize()
    twice = {n: 2 * v for n, v in per_wave.items()}
    assert {n: k.launches for n, k in counters.items()
            if k.launches} == twice
    assert {n: k.int8_launches for n, k in counters.items()
            if k.int8_launches} == twice
    assert vsconv_halo_kernel.stem_launches == 2
    with torch.inference_mode():
        ref = TG.net_apply(srv.net, srv.params,
                           torch.from_numpy(np.stack(imgs)).to(cuda),
                           sparse=srv.sparse, impl="plain").cpu().numpy()
    for i, r in enumerate(reqs):
        assert r.outcome.status == "delivered"
        assert np.isfinite(r.logits).all()
        np.testing.assert_array_equal(r.logits, ref[i])
