"""The conv kernels' int8 stem body: routing on the CPU, bits on the card.

CPU tests: `use_stem_body(..., int8=True)` holds at the three nets'
stems under the same shape rule as f32 (and not for grouped convs or
vk != 8), and `stem_smem_bytes` scales the window with the element size.

GPU tests (marked ``gpu``; the ``cuda`` fixture skips without a card): the
int8 stem body bit-equal to `vsconv_plain` / `vsconv_stack_plain` in both
layouts at ResNet-18's 7x7/s2 stem (vn 64), MobileNetV1's 3x3/s2 (vn 32),
VGG-16's conv1 (3x3/s1) and a 227 px stem (ragged 8 x 16 tiles), with
and without the epilogue, skip on and off, with ``stem_launches`` and
``int8_launches`` both moving; a sum past 2^24 (stored order kept); an
unaligned buffer (byte loads).  Run on the H100:

    PYTHONPATH=src python -m pytest tests/test_torch_stem_int8.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.core.vector_sparse import conv_cin_major, from_mask
from repro_torch.kernels import vsconv as K
from repro_torch.models import graph as TG

# name, H, cin, cout, kh, stride, vn: the int8 stems of the served nets
STEMS = [
    ("resnet18 7x7/s2", 224, 8, 64, 7, 2, 64),
    ("mobilenet_v1 3x3/s2", 224, 8, 32, 3, 2, 32),
    ("vgg16 conv1 3x3/s1", 224, 8, 64, 3, 1, 64),
    ("7x7/s2 at 227 px", 227, 8, 64, 7, 2, 64),
]


@pytest.mark.parametrize("name,h,cin,cout,kh,stride,vn", STEMS)
def test_int8_stems_take_the_stem_body(name, h, cin, cout, kh, stride, vn):
    for int8 in (False, True):
        assert K.use_stem_body(cin, 8, 1, kh, kh, vn, stride=stride,
                               int8=int8)


@pytest.mark.parametrize("c,vk,groups,kh,vn", [
    (8, 8, 2, 3, 32),     # grouped
    (16, 16, 1, 3, 64),   # vk 16
    (32, 32, 1, 3, 64),   # tiles by 32: the generic body
    (8, 8, 1, 1, 64),     # 1x1: vsmm
])
def test_int8_rule_refuses_what_f32_refuses(c, vk, groups, kh, vn):
    for int8 in (False, True):
        assert not K.use_stem_body(c, vk, groups, kh, kh, vn, int8=int8)


@pytest.mark.parametrize("kh,stride,c,vn,layout", [
    (7, 2, 8, 64, "stack"), (7, 2, 8, 64, "halo"), (3, 2, 8, 32, "halo"),
    (3, 1, 16, 64, "stack")])
def test_stem_smem_scales_with_the_element_size(kh, stride, c, vn, layout):
    """The int8 window holds a quarter of the f32 window's bytes (rows
    rounded to 16 bytes instead of padded by 4 floats); tiles a quarter."""
    geo = dict(kh=kh, kw=kh, stride=stride, dilation=1, layout=layout)
    f32 = K.stem_smem_bytes(c, vn, **geo)
    i8 = K.stem_smem_bytes(c, vn, itemsize=1, **geo)
    assert i8 < f32 / 3
    pw = K.STEM_TW + (kh - 1) // stride
    rows = (kh * stride * K.STEM_TH if layout == "stack" else
            ((K.STEM_TH - 1) * stride + kh) * stride)
    tables = 8 * kh * kh * (c // 8)
    win_f32 = rows * 4 * (pw * c + K.STEM_ROW_PAD)
    win_i8 = rows * (-(-pw * c // 16) * 16)
    assert f32 - tables == win_f32 + 4 * 2 * K.STEM_CHUNK * 8 * vn
    assert i8 - tables == win_i8 + 2 * K.STEM_CHUNK * 8 * vn
    if (kh, stride, c, layout) == (7, 2, 8, "stack"):  # ResNet-18's stem
        assert (win_f32, win_i8) == (69_888, 17_920)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _stem_weight(rng, kh, cin, cout, vn, device):
    """A dense int8 stem weight (stems stay dense), cin-major, and its
    per-column scales."""
    w = rng.standard_normal((kh * kh * cin, cout)).astype(np.float32)
    w[np.tile(np.arange(cin) >= 3, kh * kh)] = 0  # the cin padding 3 -> 8
    s = TG.weight_scales(w)
    vs = from_mask(torch.as_tensor(TG.quantize_weights_int8(w, s),
                                   device=device),
                   np.ones((kh * kh * cin // 8, cout // vn), bool), 8, vn)
    return conv_cin_major(vs, cin // 8), torch.as_tensor(s, device=device)


def _buffer(x, layout, kh, stride):
    if layout == "halo":
        return (K.build_halo_input(x, kh=kh, kw=kh, stride=stride, vk=8),
                K.vsconv_halo_kernel, K.vsconv_plain)
    return (K.build_row_tap_stack(x, kh=kh, kw=kh, stride=stride),
            K.vsconv_stack_kernel, K.vsconv_stack_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("layout", ["halo", "stack"])
@pytest.mark.parametrize("name,h,cin,cout,kh,stride,vn", STEMS)
def test_int8_stem_body_bit_equal_to_plain(cuda, name, h, cin, cout, kh,
                                           stride, vn, layout, epilogue,
                                           skip):
    """A post-ReLU input quantized on the card, its first image all zero
    in its top half (whole dead cin tiles in some windows)."""
    rng = np.random.default_rng(h + kh + vn)
    vs, s_w = _stem_weight(rng, kh, cin, cout, vn, cuda)
    x = np.maximum(rng.standard_normal((2, h, h, cin)), 0).astype(np.float32)
    x[..., 3:] = 0
    x[0, : h // 2] = 0
    xq, sx = TG.quantize_activations_int8(torch.as_tensor(x, device=cuda))
    buf, kernel, plain = _buffer(xq, layout, kh, stride)
    ho = -(-h // stride)
    kw = dict(w_out=ho, kh=kh, kw=kh, stride=stride, scale=sx * s_w)
    if epilogue:
        kw.update(bias=torch.randn(cout, device=cuda), fuse_relu=True,
                  residual=torch.randn(2, ho, ho, cout, device=cuda))
    before = (kernel.launches, kernel.stem_launches, kernel.int8_launches)
    y = kernel(buf, vs, skip_zero_inputs=skip, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.stem_launches, kernel.int8_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    ref = plain(buf, vs, **kw)
    assert torch.isfinite(y).all()
    assert torch.equal(y, ref), float((y - ref).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["halo", "stack"])
def test_int8_stem_body_keeps_stored_step_order(cuda, layout):
    """11x11/s1 over 16 channels (242 stored tiles of vk 8, the stem rule
    holds) with +-127 weights against codes of 127 and 126: the f32 sum
    passes 2^24, so only the stored order of the f32 adds gives the plain
    version's bits."""
    rng = np.random.default_rng(31)
    k, vn = 11 * 11 * 16, 32
    assert K.use_stem_body(16, 8, 1, 11, 11, vn, int8=True)
    wq = np.where(rng.random((k, vn)) < 0.9, 127, -127).astype(np.int8)
    vs = conv_cin_major(from_mask(torch.as_tensor(wq, device=cuda),
                                  np.ones((k // 8, 1), bool), 8, vn), 2)
    xq = torch.as_tensor(np.where(rng.random((1, 12, 12, 16)) < 0.5, 127,
                                  126).astype(np.int8), device=cuda)
    buf, kernel, plain = _buffer(xq, layout, 11, 1)
    kw = dict(w_out=12, kh=11, kw=11, scale=torch.ones(vn, device=cuda))
    before = kernel.stem_launches
    y = kernel(buf, vs, **kw)
    torch.cuda.synchronize()
    assert kernel.stem_launches == before + 1
    ref = plain(buf, vs, **kw)
    assert float(ref.abs().max()) > 2 ** 24
    assert torch.equal(y, ref), float((y - ref).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["halo", "stack"])
def test_int8_stem_body_takes_an_unaligned_buffer(cuda, layout):
    """A buffer starting one byte into its storage: the int8 stem body
    stages it with byte loads, with the same bits."""
    rng = np.random.default_rng(32)
    vs, s_w = _stem_weight(rng, 7, 8, 64, 64, cuda)
    x = np.maximum(rng.standard_normal((2, 32, 32, 8)), 0).astype(np.float32)
    x[..., 3:] = 0
    xq, sx = TG.quantize_activations_int8(torch.as_tensor(x, device=cuda))
    buf, kernel, plain = _buffer(xq, layout, 7, 2)
    store = torch.empty(buf.numel() + 1, dtype=torch.int8, device=cuda)
    odd = store[1:].view(buf.shape)
    odd.copy_(buf)
    kw = dict(w_out=16, kh=7, kw=7, stride=2, scale=sx * s_w)
    before = kernel.stem_launches
    y = kernel(odd, vs, **kw)
    torch.cuda.synchronize()
    assert kernel.stem_launches == before + 1
    assert torch.equal(y, plain(buf, vs, **kw))
