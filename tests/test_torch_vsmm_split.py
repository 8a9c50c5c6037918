"""vsmm's plan (row tile, split of the stored steps) and its two phases.

CPU tests: `vsmm_plan` and `chunk_bounds` (a pure function of the shapes;
every stored step in exactly one chunk, chunks contiguous and in stored
order; no split where the row tiles fill the card), and a numpy emulation
of the int8 kernel's chunk rule (exact T_c, prefix bounds, serial
recompute), which must give `vsmm_plain`'s bits on both sides of 2^24.

GPU tests (marked ``gpu``; the ``cuda`` fixture skips without a card):
the kernel at every shape of the main paths, f32 within 1e-5 and int8
bit-equal to `vsmm_plain`, with and without the epilogue; splits > 1 past
2^24 in int8 (phase 2's serial branch); two launches bit-equal; skip off
bit-equal to skip on on the split path.  Run on the H100:

    PYTHONPATH=src python -m pytest tests/test_torch_vsmm_split.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pruning import prune_vectors_balanced
from repro_torch.core.vector_sparse import from_mask
from repro_torch.kernels import vsmm as V
from repro_torch.models import graph as TG

RTOL = 1e-5
EXACT = 2 ** 24

# name, M, K, N, vk, vn, density: every vsmm shape of the main paths at
# batch 8 and 224 px (VGG-16, MobileNetV1, ResNet-18), and M = 1, 13
MAIN_SHAPES = [
    ("vgg16 fc1", 8, 25088, 4096, 32, 128, 0.235),
    ("vgg16 fc2", 8, 4096, 4096, 32, 128, 0.235),
    ("vgg16 fc3", 8, 4096, 1024, 32, 128, 0.235),
    ("mobilenet pw1", 100352, 32, 64, 32, 64, 0.5),
    ("mobilenet pw7", 1568, 512, 512, 32, 128, 0.5),
    ("mobilenet pw13", 392, 1024, 1024, 32, 128, 0.5),
    ("mobilenet head", 8, 1024, 1024, 32, 128, 0.5),
    ("resnet18 1x1/s2 projection", 6272, 64, 128, 32, 128, 0.235),
    ("resnet18 fc", 8, 512, 1024, 32, 128, 0.235),
    ("one row", 1, 512, 1024, 32, 128, 0.235),
    ("13 rows", 13, 1024, 1024, 32, 128, 0.5),
]


def _steps(k, vk, density):
    """S of a balanced-pruned (K, .) weight in (vk, .) tiles."""
    return max(1, int(round(k // vk * density)))


# --------------------------------------------------------------------------
# The plan, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s_steps,splits", [
    (184, 9), (30, 15), (16, 8), (8, 3), (5, 2), (64, 32), (1, 1), (7, 7)])
def test_chunks_cover_every_stored_step_once_in_order(s_steps, splits):
    bounds = V.chunk_bounds(s_steps, splits)
    assert len(bounds) == splits
    assert bounds[0][0] == 0 and bounds[-1][1] == s_steps
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0            # contiguous, in stored order
    steps = [s for a, b in bounds for s in range(a, b)]
    assert steps == list(range(s_steps))  # each step exactly once
    assert all(b > a for a, b in bounds)  # no empty chunk (splits <= S)


@pytest.mark.parametrize("name,m,k,n,vk,vn,density", MAIN_SHAPES)
def test_plan_of_the_main_shapes(name, m, k, n, vk, vn, density):
    """Every main-path plan is a tile the kernel takes, with no more
    chunks than steps; where it splits, chunks of at least MIN_CHUNK
    steps (one at 8 rows), as many as keep the blocks within the target
    (int8 only at m <= 32)."""
    nb, s = n // vn, _steps(k, vk, density)
    for int8 in (False, True):
        rows, splits = V.vsmm_plan(m, nb, s, vk, vn, int8)
        assert rows in V.ROW_TILES and (rows < 128 or vn <= 64)
        assert rows == 8 if m <= 8 else rows >= 32
        base = -(-m // rows) * nb
        target = V.SMALL_TARGET_BLOCKS if rows == 8 else V.TARGET_BLOCKS
        assert 1 <= splits <= s
        if splits > 1:
            assert not int8 or m <= 32
            assert s // splits >= V.min_chunk(rows)
            assert base * splits <= target
            assert splits == min(target // base, s // V.min_chunk(rows))
        assert V.vsmm_plan(m, nb, s, vk, vn, int8) == (rows, splits)


@pytest.mark.parametrize("m,nb,s", [
    (100352, 1, 1),   # MobileNetV1 pw1: 784 row tiles of 128
    (25088, 1, 2),    # pw2 / pw3
    (6272, 2, 4),     # pw4 / pw5 in 32-row tiles
    (6272, 1, 1),     # ResNet-18's first 1x1/s2 projection
])
def test_large_m_fills_the_card_without_a_split(m, nb, s):
    rows, splits = V.vsmm_plan(m, nb, s, 32, 64 if m == 100352 else 128)
    assert splits == 1
    assert -(-m // rows) * nb >= V.TARGET_BLOCKS or s < 2 * V.MIN_CHUNK


def test_fc1_at_eight_rows_splits_over_the_sms():
    """VGG-16's fc1 (32 strips of 184 stored steps at 8 rows): the old grid
    had 32 blocks; the plan cuts each strip into 16 chunks of 11-12
    steps, 512 blocks, in f32 and int8."""
    for int8 in (False, True):
        assert V.vsmm_plan(8, 32, 184, 32, 128, int8) == (8, 16)
    assert {b - a for a, b in V.chunk_bounds(184, 16)} == {11, 12}


def test_eight_row_heads_take_single_step_chunks():
    """ResNet-18's FC (8 strips of 4 steps) and MobileNetV1's head (8 of
    16) split into one-step chunks, staying within the target."""
    assert V.vsmm_plan(8, 8, 4, 32, 128) == (8, 4)
    assert V.vsmm_plan(8, 8, 16, 32, 128, int8=True) == (8, 16)
    assert V.vsmm_plan(8, 32, 30, 32, 128) == (8, 16)  # fc2: the target


def test_int8_does_not_split_past_32_rows():
    """MobileNetV1's pw7 (1568 rows, 4 strips of 8 steps): f32 splits in
    two, int8 keeps whole strips (its chunk partials cost more than the
    split gains) in 64-row tiles."""
    assert V.vsmm_plan(1568, 4, 8, 32, 128) == (64, 2)
    assert V.vsmm_plan(1568, 4, 8, 32, 128, int8=True) == (64, 1)
    assert V.vsmm_plan(13, 8, 16, 32, 128, int8=True) == (32, 8)


def test_int8_split_stays_within_int32():
    """A chunk's exact sum must fit int32: where 128^2 * vk * S reaches
    2^31 the int8 plan does not split (the f32 one does)."""
    s = 2 ** 31 // (128 * 128 * 32) + 1
    assert V.vsmm_plan(8, 8, s, 32, 128, int8=True)[1] == 1
    assert V.vsmm_plan(8, 8, s, 32, 128)[1] > 1


# --------------------------------------------------------------------------
# The int8 chunk rule, emulated in numpy
# --------------------------------------------------------------------------

def _chunk_rule(x, vals, idx, splits):
    """The int8 kernel's arithmetic in numpy: per chunk the exact sum T_c
    and the largest |chunk-local prefix sum| A_c; then, per element, an
    exact int64 walk over the chunks, float(B) where every |B| + A_c <=
    2^24, else the serial stored-order f32 sum.  Returns (y, serial mask)."""
    m = x.shape[0]
    nb, s_steps, vk, vn = vals.shape
    xt = x.astype(np.int64).reshape(m, -1, vk)
    # p[s, m, j, n]: each stored step's exact partial
    p = np.stack([np.einsum("mjk,jkn->mjn", xt[:, idx[:, s]],
                            vals[:, s].astype(np.int64))
                  for s in range(s_steps)])
    base = np.zeros(p.shape[1:], np.int64)
    exact = np.ones(p.shape[1:], bool)
    for a, b in V.chunk_bounds(s_steps, splits):
        pre = np.cumsum(p[a:b], axis=0)
        exact &= np.abs(base) + np.abs(pre).max(axis=0) <= EXACT
        base += pre[-1]
    serial = np.zeros(p.shape[1:], np.float32)
    for s in range(s_steps):  # the reference's adds, in stored order
        serial = serial + p[s].astype(np.float32)
    y = np.where(exact, base.astype(np.float32), serial)
    return y.reshape(m, nb * vn), ~exact.reshape(m, nb * vn)


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("splits", [2, 5, 16])
def test_int8_chunk_rule_gives_the_plain_bits(big, splits):
    """Below 2^24 the rule takes float(B) everywhere; with +-127 over 64
    steps (sums past 2^24) it recomputes serially; both give
    `vsmm_plain`'s bits."""
    rng = np.random.default_rng(splits + 7 * big)
    m, k, n, vk, vn = 6, 2048, 256, 32, 128
    if big:
        wq = np.where(rng.random((k, n)) < 0.9, 127, -127).astype(np.int8)
        xq = np.where(rng.random((m, k)) < 0.5, 127, 126).astype(np.int8)
    else:
        wq = rng.integers(-40, 41, (k, n)).astype(np.int8)
        xq = rng.integers(0, 30, (m, k)).astype(np.int8)
    vs = from_mask(torch.as_tensor(wq), np.ones((k // vk, n // vn), bool),
                   vk, vn)
    y, serial = _chunk_rule(xq, vs.vals.numpy(), vs.idx.numpy(), splits)
    ref = V.vsmm_plain(torch.as_tensor(xq), vs, scale=torch.ones(n)).numpy()
    np.testing.assert_array_equal(y, ref)
    assert serial.any() == big
    if big:
        assert np.abs(ref).max() > EXACT


# --------------------------------------------------------------------------
# The kernel, on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _weights(rng, k, n, vk, vn, density, device, int8):
    """A balanced-pruned weight, encoded (int8: quantized as `sparsify`
    does) on ``device``, and its scales (None for f32)."""
    w = rng.standard_normal((k, n)).astype(np.float32)
    w, mask = prune_vectors_balanced(w, density, vk, vn)
    if not int8:
        return from_mask(torch.as_tensor(w, device=device), mask, vk, vn), None
    s = TG.weight_scales(w)
    return (from_mask(torch.as_tensor(TG.quantize_weights_int8(w, s),
                                      device=device), mask, vk, vn),
            torch.as_tensor(s, device=device))


def _case(rng, m, k, n, vk, vn, density, device, dtype, epilogue):
    """(x, weight, kwargs) for a post-ReLU input, int8-quantized on the
    card for ``dtype`` "int8"."""
    int8 = dtype == "int8"
    vs, s_w = _weights(rng, k, n, vk, vn, density, device, int8)
    x = torch.relu(torch.as_tensor(
        rng.standard_normal((m, k)).astype(np.float32), device=device))
    kw = {}
    if int8:
        x, sx = TG.quantize_activations_int8(x)
        kw["scale"] = sx * s_w
    if epilogue:
        kw.update(bias=torch.randn(n, device=device), fuse_relu=True,
                  residual=torch.randn(m, n, device=device))
    return x, vs, kw


def _assert_matches(y, ref, dtype):
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    if dtype == "int8":
        assert torch.equal(y, ref), float((y - ref).abs().max())
    else:
        assert _rel(y, ref) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("name,m,k,n,vk,vn,density", MAIN_SHAPES)
def test_vsmm_at_main_path_shapes(cuda, name, m, k, n, vk, vn, density,
                                  dtype, epilogue):
    rng = np.random.default_rng(m + k + n)
    x, vs, kw = _case(rng, m, k, n, vk, vn, density, cuda, dtype, epilogue)
    before = (V.vsmm_kernel.launches, V.vsmm_kernel.int8_launches)
    y = V.vsmm_kernel(x, vs, **kw)
    torch.cuda.synchronize()
    assert (V.vsmm_kernel.launches, V.vsmm_kernel.int8_launches) == (
        before[0] + 1, before[1] + (dtype == "int8"))
    _assert_matches(y, V.vsmm_plain(x, vs, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 13])
def test_vsmm_int8_split_keeps_stored_step_order(cuda, m):
    """`test_vsmm_int8_kernel_keeps_stored_step_order` on the split path:
    +-127 weights over 64 stored steps, sums past 2^24, so phase 2 takes
    its serial branch for those elements; bit-equal to plain."""
    rng = np.random.default_rng(m)
    k, n, vk, vn = 2048, 128, 32, 128
    assert V.vsmm_plan(m, 1, 64, vk, vn, int8=True)[1] > 1
    wq = np.where(rng.random((k, n)) < 0.9, 127, -127).astype(np.int8)
    xq = np.where(rng.random((m, k)) < 0.5, 127, 126).astype(np.int8)
    vs = from_mask(torch.as_tensor(wq, device=cuda),
                   np.ones((k // vk, n // vn), bool), vk, vn)
    x = torch.as_tensor(xq, device=cuda)
    scale = torch.ones(n, device=cuda)
    y = V.vsmm_kernel(x, vs, scale=scale)
    torch.cuda.synchronize()
    ref = V.vsmm_plain(x, vs, scale=scale)
    assert float(ref.abs().max()) > EXACT
    assert torch.equal(y, ref), float((y - ref).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_vsmm_split_is_bit_deterministic(cuda, dtype):
    """Two launches at VGG-16's fc1 shape (16 chunks a strip) give the same
    bits: phase 2 combines the chunks in chunk order."""
    rng = np.random.default_rng(21)
    x, vs, kw = _case(rng, 8, 25088, 4096, 32, 128, 0.235, cuda, dtype,
                      True)
    assert V.vsmm_plan(8, 32, vs.vals.shape[1], 32, 128,
                       dtype == "int8")[1] > 1
    y1 = V.vsmm_kernel(x, vs, **kw)
    y2 = V.vsmm_kernel(x, vs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_vsmm_split_skip_off_bit_equal_to_skip_on(cuda, dtype):
    """The split path with whole zero K-tiles in x (the skip-on kernel
    skips those steps): skip off gives the same bits, equal to plain."""
    rng = np.random.default_rng(22)
    x, vs, kw = _case(rng, 8, 4096, 1024, 32, 128, 0.235, cuda, dtype, True)
    x[:, : 4096 // 2] = 0  # half the K-tiles all zero
    assert V.vsmm_plan(8, 8, vs.vals.shape[1], 32, 128,
                       dtype == "int8")[1] > 1
    y_on = V.vsmm_kernel(x, vs, **kw)
    y_off = V.vsmm_kernel(x, vs, skip_zero_inputs=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y_on, y_off)
    _assert_matches(y_off, V.vsmm_plain(x, vs, **kw), dtype)
