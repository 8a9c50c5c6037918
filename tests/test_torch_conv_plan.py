"""The generic conv body's plan and its int8 arithmetic, on the CPU.

`conv_plan` (kernels/vsconv.py) cuts a conv from its shapes alone into
tiles of 64 or 128 output pixels, the output strips and, where those do
not fill the H100's 132 SMs, chunks of each strip's stored steps.  At every
generic layer of VGG-16 and ResNet-18 (batch 8 at 224 px, and the CPU
tests' batch 2 at 32 px): a tile the kernel has, blocks that fill the SMs
where the shape allows, two blocks' shared memory within an SM's, chunks
that cover every stored step once and in order, and int8 splits only
under vsmm's exact-sum rule.  The wrapper hands the kernel the plan and a
workspace of the right size (its launch recorded, not run: there is no
card here).

The int8 body starts each stored tile's mma accumulator from 0x4B400000,
the f32 bits of 1.5 * 2^23, and reads the exact partial back as a float
minus 1.5 * 2^23: a numpy emulation shows that equal to float(partial)
bit for bit over every partial a vk-32 tile can give (|p| <= 2^19).

`chip_smoke.generic_instantiations` reads the body's registers and spills
from ``nvcc -Xptxas -v`` output (a log laid down by hand here).

The kernels themselves are tested on the card (tests/test_torch_conv_tiled.py).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.pruning import prune_vectors_balanced
from repro_torch.core.vector_sparse import conv_cin_major, from_mask
from repro_torch.kernels import vsconv as K
from repro_torch.kernels.vsmm import SMS, TARGET_BLOCKS, chunk_bounds
from repro_torch.models.graph import conv_tile_geometry

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

DENSITY = 0.235
SM_SMEM = 228 * 1024      # an H100 SM's shared memory
BLOCK_RESERVED = 1024     # the system's share of it a block
MAGIC_BITS = 0x4B400000
MAGIC = np.float32(1.5 * 2 ** 23)

# name, input size at 224 px, cin, cout, stride: every conv that runs the
# generic body (kh*kw > 1, not a stem); all 3x3
VGG16 = [("conv2", 224, 64, 64, 1), ("conv3", 112, 64, 128, 1),
         ("conv4", 112, 128, 128, 1), ("conv5", 56, 128, 256, 1),
         ("conv6", 56, 256, 256, 1), ("conv7", 56, 256, 256, 1),
         ("conv8", 28, 256, 512, 1), ("conv9", 28, 512, 512, 1),
         ("conv10", 28, 512, 512, 1), ("conv11", 14, 512, 512, 1),
         ("conv12", 14, 512, 512, 1), ("conv13", 14, 512, 512, 1)]
RESNET18 = ([(f"layer1.{i}", 56, 64, 64, 1) for i in range(4)]
            + [("layer2.0a", 56, 64, 128, 2)]
            + [(f"layer2.{i}", 28, 128, 128, 1) for i in range(3)]
            + [("layer3.0a", 28, 128, 256, 2)]
            + [(f"layer3.{i}", 14, 256, 256, 1) for i in range(3)]
            + [("layer4.0a", 14, 256, 512, 2)]
            + [(f"layer4.{i}", 7, 512, 512, 1) for i in range(3)])
LAYERS = ([("vgg16", *l) for l in VGG16]
          + [("resnet18", *l) for l in RESNET18])


def _shapes(h224, cin, cout, stride, *, size, batch):
    """(m, nb, S, vk, vn) of a generic layer at image ``size``."""
    g = conv_tile_geometry(3, 3, cin, cout)
    h = max(1, h224 * size // 224)
    ho = -(-h // stride)
    return (batch * ho * ho, g.nb, max(1, int(round(g.kb * DENSITY))),
            g.vk, g.vn)


@pytest.mark.parametrize("size,batch", [(224, 8), (32, 2)])
@pytest.mark.parametrize("net,name,h224,cin,cout,stride", LAYERS)
def test_plan_of_every_generic_layer(net, name, h224, cin, cout, stride,
                                     size, batch):
    m, nb, s_steps, vk, vn = _shapes(h224, cin, cout, stride, size=size,
                                     batch=batch)
    assert K.conv_fast(vk, vn)  # every generic layer has a fast body
    for int8 in (False, True):
        rows, splits = K.conv_plan(m, nb, s_steps, vk, vn, int8=int8)
        assert rows in K.CONV_ROWS
        base = -(-m // rows) * nb
        # 128-row tiles only where they alone give two blocks an SM
        assert (rows == 128) == (-(-m // 128) * nb >= TARGET_BLOCKS)
        assert 1 <= splits <= s_steps
        if base >= SMS:
            assert splits == 1
        else:  # as many chunks as the steps and the target allow
            assert splits == max(1, min(TARGET_BLOCKS // base,
                                        s_steps // K.CONV_MIN_CHUNK))
            assert base * splits <= TARGET_BLOCKS
        if splits > 1:
            assert s_steps // splits >= K.CONV_MIN_CHUNK
            assert not int8 or 128 * 128 * vk * s_steps < 2 ** 31
        # two blocks an SM: dynamic + static (pixel bases) + reserved
        smem = K.conv_smem_bytes(rows, vk, vn, int8=int8)
        assert smem <= 227 * 1024
        assert 2 * (smem + 8 * rows + BLOCK_RESERVED) <= SM_SMEM
        bounds = chunk_bounds(s_steps, splits)
        assert [s for a, b in bounds for s in range(a, b)] == list(
            range(s_steps))
        assert all(b > a for a, b in bounds)
        assert K.conv_plan(m, nb, s_steps, vk, vn, int8=int8) == (rows,
                                                                   splits)


@pytest.mark.parametrize("name,h224,cin,cout,plan", [
    ("VGG-16 conv2", 224, 64, 64, (128, 1)),    # 3136 tiles of 128
    ("VGG-16 conv4", 112, 128, 128, (128, 1)),
    ("VGG-16 conv9", 28, 512, 512, (64, 1)),    # 98 tiles x 4 strips
    ("VGG-16 conv11", 14, 512, 512, (64, 2)),   # 25 x 4: split
    ("ResNet-18 layer1", 56, 64, 64, (64, 1)),
    ("ResNet-18 layer3", 14, 256, 256, (64, 5)),
    ("ResNet-18 layer4", 7, 512, 512, (64, 9)),  # 7 tiles x 4 strips
])
def test_small_maps_split_and_large_ones_do_not(name, h224, cin, cout, plan):
    """The layers that cannot fill the SMs with row tiles split their
    stored steps (ResNet-18's layer4, m 392; VGG-16's conv11-13, m 1568),
    in f32 and int8 alike; the large ones take 128-row tiles whole."""
    m, nb, s_steps, vk, vn = _shapes(h224, cin, cout, 1, size=224, batch=8)
    for int8 in (False, True):
        assert K.conv_plan(m, nb, s_steps, vk, vn, int8=int8) == plan
        rows, splits = plan
        assert -(-m // rows) * nb * splits >= SMS


def test_int8_split_stays_within_int32():
    """A chunk's exact int32 sum must not overflow: where 128^2 * vk * S
    reaches 2^31 the int8 plan does not split (the f32 one does)."""
    s = 2 ** 31 // (128 * 128 * 32) + 1
    assert K.conv_plan(392, 4, s, 32, 128, int8=True)[1] == 1
    assert K.conv_plan(392, 4, s, 32, 128)[1] > 1


@pytest.mark.parametrize("vk,vn", [(16, 16), (6, 6), (32, 96), (8, 64)])
def test_general_shapes_take_64_row_tiles(vk, vn):
    """Shapes without a fast instantiation (grouped, vk < 32, vn not 64 or
    128) run the general one, whose tiles have 64 rows, at any m."""
    assert not K.conv_fast(vk, vn)
    for m in (147, 100352):
        for int8 in (False, True):
            rows, _ = K.conv_plan(m, 1, 9, vk, vn, int8=int8)
            assert rows == 64
            assert 2 * (K.conv_smem_bytes(rows, vk, vn, int8=int8)
                        + 8 * rows + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("layout", ["halo", "stack"])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_wrapper_passes_the_plan_and_a_workspace(monkeypatch, layout,
                                                 dtype):
    """`_conv_kernel` (the wrappers' launch) gives the entry the plan
    (rows, splits) after the shape ints, and a workspace of splits x M x N
    f32 (int8: int32 pairs) where it splits; the launch is recorded, not
    run."""
    calls = []
    monkeypatch.setattr(K, "launch", lambda *a: calls.append(a))
    rng = np.random.default_rng(3)
    n, size, c = 8, 7, 512
    w = rng.standard_normal((9 * c, c)).astype(np.float32)
    wp, mask = prune_vectors_balanced(w, DENSITY, 32, 128)
    if dtype == "int8":
        wp = np.clip(np.round(wp * 64), -127, 127).astype(np.int8)
    vs = conv_cin_major(from_mask(torch.as_tensor(wp), mask, 32, 128),
                        c // 32)
    x = torch.zeros((n, size, size, c), dtype=torch.int8 if dtype == "int8"
                    else torch.float32)
    scale = torch.ones(c) if dtype == "int8" else None
    if layout == "halo":
        buf = K.build_halo_input(x, kh=3, kw=3, vk=32)
        d0, bw = buf.shape[1], buf.shape[2]
        fn = "vsconv_halo_launch"
    else:
        buf = K.build_row_tap_stack(x, kh=3, kw=3)
        d0, bw = buf.shape[1], buf.shape[3]
        fn = "vsconv_stack_launch"
    out, stem, int8 = K._conv_kernel(
        fn, buf, vs, h_out=size, w_out=size, d0=d0, bw=bw, c=c, vk=32, kh=3,
        kw=3, stride=1, dilation=1, groups=1, bias=None, residual=None,
        scale=scale, fuse_relu=False, skip_zero_inputs=True)
    assert not stem and int8 == (dtype == "int8")
    (name, entry, tensors, ints, _), = calls
    s_steps = vs.vals.shape[1]
    rows, splits = K.conv_plan(n * size * size, 4, s_steps, 32, 128,
                               int8=int8)
    assert splits > 1
    assert entry == fn.replace("_launch", "_int8_launch" if int8
                               else "_launch")
    assert tuple(ints[-2:]) == (rows, splits)
    work = tensors[-1]
    m = n * size * size
    assert tuple(work.shape) == ((splits, m, c, 2) if int8
                                 else (splits, m, c))
    assert work.dtype == (torch.int32 if int8 else torch.float32)


def test_wrapper_refuses_vk_past_32():
    """The generic body takes vk <= 32: a wider K-tile raises before any
    launch."""
    vs = from_mask(torch.ones(9 * 64, 64), np.ones((9, 1), bool), 64, 64)
    buf = K.build_halo_input(torch.zeros(1, 4, 4, 64), kh=3, kw=3, vk=64)
    with pytest.raises(ValueError, match="vk <= 32"):
        K._conv_kernel("vsconv_halo_launch", buf, vs, h_out=4, w_out=4,
                       d0=buf.shape[1], bw=buf.shape[2], c=64, vk=64, kh=3,
                       kw=3, stride=1, dilation=1, groups=1, bias=None,
                       residual=None, scale=None, fuse_relu=False,
                       skip_zero_inputs=True)


def _magic_partial(p: np.ndarray) -> np.ndarray:
    """The kernel's read-back of an int32 partial p accumulated onto
    0x4B400000: D's bits as a float, minus 1.5 * 2^23."""
    d = (np.int64(MAGIC_BITS) + p.astype(np.int64)).astype(np.int32)
    return d.view(np.float32) - MAGIC


def test_magic_partial_is_exact_over_every_tile_partial():
    """Every partial a vk-32 int8 tile gives, |p| <= 128^2 * 32 = 2^19,
    reads back as float(p), bit for bit (the sign of zero too)."""
    p = np.arange(-2 ** 19, 2 ** 19 + 1, dtype=np.int64)
    got = _magic_partial(p)
    want = p.astype(np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("a,b", [(-128, -128), (-128, 127), (127, 127),
                                 (127, -128), (0, -128)])
def test_magic_partial_at_the_extremes(a, b):
    """A whole k-32 column of one product: (-128)(-128)*32 = 2^19, the
    largest partial, and the most negative, -128*127*32."""
    p = np.array([a * b * 32], np.int64)
    assert _magic_partial(p)[0] == np.float32(a * b * 32)
    assert abs(int(p[0])) <= 2 ** 19 < 2 ** 22


@pytest.mark.parametrize("seed", range(4))
def test_magic_tile_partials_add_like_the_reference(seed):
    """A strip of 40 random int8 16 x 32 x 8 tiles: the magic read-back
    added into an f32 accumulator in stored order gives the reference's
    f32 sum of the exact partials, bit for bit."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (40, 16, 32)).astype(np.int64)
    b = rng.integers(-128, 128, (40, 32, 8)).astype(np.int64)
    acc = np.zeros((16, 8), np.float32)
    ref = np.zeros((16, 8), np.float32)
    for t in range(40):
        p = a[t] @ b[t]
        acc = acc + _magic_partial(p)
        ref = ref + p.astype(np.float32)
    assert np.array_equal(acc, ref)


_VS = "_ZN42_GLOBAL__N__0c1d2e3f_9_vsconv_cu_4a5b6c7d"


def _entry(name: str, regs: int, spill: int = 0) -> str:
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\n    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\nptxas info    : Used {regs} "
            f"registers, used 1 barriers\n")


def test_generic_instantiations_name_tile_and_branch():
    """The generic body's phase-1 kernels name their tile (rows x vn),
    fast or general, and (int8) split; phase 2 is filed under its
    kernel; the int8 ones also count among the int8 instantiations, and
    the profiler files each under its kernel."""
    conv = (_entry(f"{_VS}18vsconv_halo_kernelILi8ELi8ELb1EEEvN3gen4ConvE",
                   126)
            + _entry(f"{_VS}19vsconv_stack_kernelILi4ELi8ELb0EEEvN3gen4ConvE",
                     90)
            + _entry(f"{_VS}23vsconv_halo_int8_kernelILi2ELi4ELb1ELb1EEEvN3"
                     f"gen4ConvE", 100, spill=8)
            + _entry(f"{_VS}24vsconv_stack_int8_kernelILi2ELi2ELb1ELb0EEEvN3"
                     f"gen4ConvE", 96)
            + _entry(f"{_VS}25vsconv_halo_reduce_kernelEN3gen4ConvE", 20)
            + _entry(f"{_VS}30vsconv_stack_int8_reduce_kernelEN3gen4ConvE",
                     40)
            + _entry(f"{_VS}23vsconv_halo_stem_kernelILi2ELi8EEEvPKf", 90))
    rows = chip_smoke.generic_instantiations(conv)
    by = {(r["kernel"], r.get("rows"), r.get("vn")): r for r in rows}
    assert len(rows) == 6  # the stem body is not one of them
    assert by[("vsconv_halo", 128, 128)]["fast"] is True
    assert by[("vsconv_stack", 64, 128)]["fast"] is False
    split = by[("vsconv_halo_int8", 64, 128)]
    assert split["split"] is True and split["spill_stores"] == 8
    assert by[("vsconv_stack_int8", 128, 64)]["split"] is False
    assert ("vsconv_halo_reduce", None, None) in by
    assert ("vsconv_stack_int8_reduce", None, None) in by
    int8 = chip_smoke.int8_instantiations({"vsmm": "", "vsconv": conv,
                                           "vsconv_dw": ""})
    assert {r["kernel"] for r in int8} == {
        "vsconv_halo_int8", "vsconv_stack_int8", "vsconv_stack_int8_reduce"}
    assert chip_smoke._kind(
        f"{_VS}30vsconv_stack_int8_reduce_kernelEN3gen4ConvE") == \
        "vsconv_stack_int8"
    assert chip_smoke._kind(
        "void (anonymous namespace)::vsconv_halo_kernel<8, 8, true>("
        "(anonymous namespace)::gen::Conv)") == "vsconv_halo"
