"""The generic conv body (register-tiled f32 and mma.sync int8 on a
cp.async ring, with split stored steps) against its plain versions, on
the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
where there is none.  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest tests/test_torch_conv_tiled.py -q

Both layouts (halo, stack), f32 and int8, with and without the epilogue
(bias + residual + ReLU), at VGG-16's conv2, conv9 and conv11 and
ResNet-18's layer1, layer2 (3x3/s2) and layer4 shapes (each with its own
plan: 128-row tiles, 64-row tiles, split stored steps), and at shapes off
the main path: vn 16 (grouped 64 -> 64, groups 4), dilation 2, a ragged
row tail, Hout < 4, vk 6 and vn 96 (the general instantiation).  f32
within a relative 1e-5 of max|y| (only the order of the f32 sums
differs); int8 bit for bit, also past 2^24 with a split (phase 2's serial
branch).  Skip off bit-equal to skip on; two launches bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pruning import prune_vectors_balanced
from repro_torch.core.vector_sparse import conv_cin_major, from_mask
from repro_torch.kernels import vsconv as K
from repro_torch.models import graph as TG

pytestmark = pytest.mark.gpu

RTOL = 1e-5
EXACT = 2 ** 24

# name, N, H, cin, cout, stride, dilation, groups, vk, vn, density
SHAPES = [
    ("VGG-16 conv2 (128-row tiles, vn 64)", 2, 224, 64, 64, 1, 1, 1, 32, 64,
     0.235),
    ("VGG-16 conv9", 8, 28, 512, 512, 1, 1, 1, 32, 128, 0.235),
    ("VGG-16 conv11 (split)", 8, 14, 512, 512, 1, 1, 1, 32, 128, 0.235),
    ("ResNet-18 layer1", 8, 56, 64, 64, 1, 1, 1, 32, 64, 0.235),
    ("ResNet-18 layer2 3x3/s2 (split)", 8, 56, 64, 128, 2, 1, 1, 32, 128,
     0.235),
    ("ResNet-18 layer4 (split)", 8, 7, 512, 512, 1, 1, 1, 32, 128, 0.235),
    ("grouped 64->64 groups 4, vn 16", 2, 16, 64, 64, 1, 1, 4, 16, 16, 0.5),
    ("dilation 2", 2, 15, 64, 64, 1, 2, 1, 32, 64, 0.5),
    ("ragged row tail (m 147)", 3, 7, 128, 128, 1, 1, 1, 32, 128, 0.5),
    ("Hout < 4", 2, 3, 128, 128, 1, 1, 1, 32, 128, 0.5),
    ("vk 6 (general)", 2, 11, 12, 12, 2, 1, 1, 6, 6, 0.5),
    ("vn 96 (general)", 2, 12, 64, 96, 1, 1, 1, 32, 96, 0.5),
]


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


def _case(cuda, n, h, cin, cout, stride, dil, groups, vk, vn, density,
          layout, dtype, epilogue, seed=0, zero_first=False):
    """(kernel, plain, buffer, weight, kwargs) of one conv: a
    balanced-pruned weight (int8: quantized as `sparsify` does) and a
    post-ReLU input (int8: quantized on the card)."""
    rng = np.random.default_rng(seed + h + cin + cout + groups)
    cin_g = cin // groups
    w = rng.standard_normal((9 * cin_g, cout)).astype(np.float32)
    w, mask = prune_vectors_balanced(w, density, vk, vn)
    x = torch.relu(torch.as_tensor(
        rng.standard_normal((n, h, h, cin)).astype(np.float32), device=cuda))
    if zero_first:
        x[0] = 0
    ho = -(-h // stride)
    kw = dict(w_out=ho, kh=3, kw=3, stride=stride, dilation=dil,
              groups=groups)
    if dtype == "int8":
        s_w = TG.weight_scales(w)
        w = TG.quantize_weights_int8(w, s_w)
        x, sx = TG.quantize_activations_int8(x)
        kw["scale"] = sx * torch.as_tensor(s_w, device=cuda)
    vs = conv_cin_major(from_mask(torch.as_tensor(w, device=cuda), mask, vk,
                                  vn), cin_g // vk)
    if epilogue:
        kw.update(bias=torch.randn(cout, device=cuda), fuse_relu=True,
                  residual=torch.randn(n, ho, ho, cout, device=cuda))
    if layout == "halo":
        buf = K.build_halo_input(x, kh=3, kw=3, stride=stride, dilation=dil,
                                 vk=vk)
        return K.vsconv_halo_kernel, K.vsconv_plain, buf, vs, kw
    buf = K.build_row_tap_stack(x, kh=3, kw=3, stride=stride, dilation=dil)
    return K.vsconv_stack_kernel, K.vsconv_stack_plain, buf, vs, kw


def _assert_matches(y, ref, dtype):
    assert y.shape == ref.shape and torch.isfinite(y).all()
    if dtype == "int8":
        assert torch.equal(y, ref), float((y - ref).abs().max())
    else:
        assert _rel(y, ref) <= RTOL


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("layout", ["halo", "stack"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_generic_body_matches_plain(cuda, shape, layout, dtype, epilogue):
    _, n, h, cin, cout, stride, dil, groups, vk, vn, density = shape
    kernel, plain, buf, vs, kw = _case(cuda, n, h, cin, cout, stride, dil,
                                       groups, vk, vn, density, layout,
                                       dtype, epilogue)
    assert not K.use_stem_body(cin, vk, groups, 3, 3, vn, stride=stride,
                               dilation=dil, int8=dtype == "int8")
    before = (kernel.launches, kernel.int8_launches, kernel.stem_launches)
    y = kernel(buf, vs, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.int8_launches, kernel.stem_launches) == (
        before[0] + 1, before[1] + (dtype == "int8"), before[2])
    _assert_matches(y, plain(buf, vs, **kw), dtype)


@pytest.mark.parametrize("layout", ["halo", "stack"])
def test_int8_split_keeps_stored_step_order(cuda, layout):
    """+-127 weights over 72 stored steps against codes of 127 and 126 at
    36 pixels: one row tile, so the plan splits the steps; the sums pass
    2^24, so phase 2 recomputes those elements serially in stored order;
    bit-equal to plain."""
    rng = np.random.default_rng(11)
    k, n, vk, vn = 9 * 256, 128, 32, 128
    wq = np.where(rng.random((k, n)) < 0.9, 127, -127).astype(np.int8)
    vs = conv_cin_major(from_mask(torch.as_tensor(wq, device=cuda),
                                  np.ones((k // vk, n // vn), bool), vk, vn),
                        256 // vk)
    assert K.conv_plan(36, 1, 72, vk, vn, int8=True)[1] > 1
    xq = torch.as_tensor(np.where(rng.random((1, 6, 6, 256)) < 0.5, 127,
                                  126).astype(np.int8), device=cuda)
    scale = torch.ones(n, device=cuda)
    if layout == "halo":
        buf = K.build_halo_input(xq, kh=3, kw=3, vk=vk)
        kernel, plain = K.vsconv_halo_kernel, K.vsconv_plain
    else:
        buf = K.build_row_tap_stack(xq, kh=3, kw=3)
        kernel, plain = K.vsconv_stack_kernel, K.vsconv_stack_plain
    y = kernel(buf, vs, w_out=6, scale=scale)
    torch.cuda.synchronize()
    ref = plain(buf, vs, w_out=6, scale=scale)
    assert float(ref.abs().max()) > EXACT
    assert torch.equal(y, ref), float((y - ref).abs().max())


SPLIT_AND_WHOLE = [s for s in SHAPES if s[0].startswith(
    ("ResNet-18 layer4", "ResNet-18 layer1", "VGG-16 conv11"))]


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("layout", ["halo", "stack"])
@pytest.mark.parametrize("shape", SPLIT_AND_WHOLE,
                         ids=[s[0] for s in SPLIT_AND_WHOLE])
def test_skip_off_bit_equal_to_skip_on(cuda, shape, layout, dtype):
    """A post-ReLU input whose first image is all zero (the skip-on kernel
    skips those tiles' MACs): skip off gives the same bits, and both
    match plain."""
    _, n, h, cin, cout, stride, dil, groups, vk, vn, density = shape
    kernel, plain, buf, vs, kw = _case(cuda, n, h, cin, cout, stride, dil,
                                       groups, vk, vn, density, layout,
                                       dtype, True, zero_first=True)
    y_on = kernel(buf, vs, **kw)
    y_off = kernel(buf, vs, skip_zero_inputs=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y_on, y_off)
    _assert_matches(y_off, plain(buf, vs, **kw), dtype)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("layout", ["halo", "stack"])
@pytest.mark.parametrize("shape", SPLIT_AND_WHOLE,
                         ids=[s[0] for s in SPLIT_AND_WHOLE])
def test_two_launches_bit_equal(cuda, shape, layout, dtype):
    """No atomics: phase 2 sums the chunks in chunk order, so two launches
    of a split conv (and of a whole one) give the same bits."""
    _, n, h, cin, cout, stride, dil, groups, vk, vn, density = shape
    kernel, _, buf, vs, kw = _case(cuda, n, h, cin, cout, stride, dil,
                                   groups, vk, vn, density, layout, dtype,
                                   True, seed=1)
    y1 = kernel(buf, vs, **kw)
    y2 = kernel(buf, vs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


def test_unaligned_int8_buffer_takes_byte_copies(cuda):
    """An int8 halo buffer that starts one byte into its storage: the
    activation rows are not 4-byte aligned, so the body stages them by
    byte loads; bit-equal to plain."""
    kernel, plain, buf, vs, kw = _case(cuda, 2, 12, 64, 64, 1, 1, 1, 32, 64,
                                       0.5, "halo", "int8", True)
    store = torch.empty(buf.numel() + 1, dtype=torch.int8, device=cuda)
    shifted = store[1:].view(buf.shape)
    shifted.copy_(buf)
    assert shifted.data_ptr() % 4 == 1
    y = kernel(shifted, vs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, plain(buf, vs, **kw))
