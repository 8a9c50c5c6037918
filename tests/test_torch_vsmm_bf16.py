"""vsmm's bf16 branch and ``out_dtype``: the plain version against the
reference, the wrapper's checks, and (on the card) the kernel.

CPU tests: `vsmm_plain` on bf16 operands with an f32 output against the
reference's `vsmm_pallas(..., interpret=True, out_dtype=float32)` and
against its sparse FFN product `repro.models.sparse_lm._vs_mm`, at the
FFN's awkward tiles (vk 27, vn 108) and with distinct K-tile ids per
strip, within relative 1e-5 of max|y| (both sides add exact bf16 x bf16
products in f32; only the summation order differs); the default output
dtype (x's, f32 for int8) and its rounding; `check_operands` and
`entry_name` for the three branches.

GPU tests (marked ``gpu``; the ``cuda`` fixture skips without a card):
the bf16 kernel (on the tensor cores, tiled by `vsmm_bf16_plan`) at the
sparse FFN's shapes of Qwen1.5-4B (``wi`` and the merged ``wo``, vk 27)
and Phi-3-medium (vn 112) at M = 8 and 1024, and on pruned random
weights (ids differing strip to strip), against `vsmm_plain` on the card
(f32 out, relative 1e-5); a bf16 output equal to the kernel's f32 output
rounded; skip off bit-equal to skip on (with -0.0 tiles, which the vote
counts as zero); the epilogue; a split plan; two launches bit-equal; the
counters; a sweep of M over both tilings (1 to 4096) x vk (8 to 64, 27
odd) x vn (10 to 128, 108 and 112 not multiples of 16), equal and
distinct ids, the epilogue and zero tiles, each case held to all of
those; a CUDA graph's replay bit-equal to the eager call, at a split
and an unsplit plan.  Run on the H100:

    PYTHONPATH=src python -m pytest tests/test_torch_vsmm_bf16.py -q
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.core.vector_sparse import VectorSparse as RefVS
from repro.kernels.vsmm import vsmm_pallas
from repro.models import sparse_lm as RSL
from repro_torch.core.pruning import prune_vectors_balanced
from repro_torch.core.vector_sparse import VectorSparse, decode, from_mask
from repro_torch.kernels import vsmm as V

RTOL = 1e-5


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _operands(seed, m, nb, s, vk, vn, kb, *, distinct=True):
    """bf16 numpy x (m, kb*vk), vals (nb, s, vk, vn) and int32 idx (nb, s):
    sorted ids, drawn per strip (``distinct``) or the schema's evenly
    spaced row in every strip."""
    rng = np.random.default_rng(seed)
    if distinct:
        idx = np.stack([np.sort(rng.choice(kb, s, replace=False))
                        for _ in range(nb)]).astype(np.int32)
    else:
        row = np.sort((np.arange(s) * max(1, kb // s)) % kb)
        idx = np.ascontiguousarray(np.broadcast_to(row, (nb, s)),
                                   dtype=np.int32)
    vals = (rng.standard_normal((nb, s, vk, vn)) / np.sqrt(kb * vk)
            ).astype(jnp.bfloat16)
    x = rng.standard_normal((m, kb * vk)).astype(jnp.bfloat16)
    return x, vals, idx


def _torch_bf16(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(
        torch.bfloat16).to(device)


# name, M, NB, S, vk, vn, KB
CPU_CASES = [
    ("ffn wo tile vk 27 vn 128", 8, 4, 3, 27, 128, 16),
    ("ffn wi tile vk 32 vn 108", 8, 3, 4, 32, 108, 19),
    ("vk 27 vn 108, 13 rows", 13, 3, 5, 27, 108, 9),
]


@pytest.mark.parametrize("distinct", [True, False])
@pytest.mark.parametrize("name,m,nb,s,vk,vn,kb", CPU_CASES)
def test_plain_bf16_matches_the_reference_kernel(name, m, nb, s, vk, vn,
                                                  kb, distinct):
    x, vals, idx = _operands(3, m, nb, s, vk, vn, kb, distinct=distinct)
    shape = (kb * vk, nb * vn)
    ref = vsmm_pallas(jnp.asarray(x), RefVS(vals=jnp.asarray(vals),
                                            idx=jnp.asarray(idx),
                                            shape=shape),
                      bm=m, interpret=True, out_dtype=jnp.float32)
    got = V.vsmm_plain(_torch_bf16(x), VectorSparse(
        _torch_bf16(vals), torch.from_numpy(idx), shape),
        out_dtype=torch.float32)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert _rel(got.numpy(), ref) <= RTOL, name


@pytest.mark.parametrize("name,m,nb,s,vk,vn,kb", CPU_CASES)
def test_plain_bf16_matches_the_reference_ffn_product(name, m, nb, s, vk,
                                                      vn, kb):
    x, vals, idx = _operands(4, m, nb, s, vk, vn, kb)
    ref = RSL._vs_mm(jnp.asarray(x).reshape(m, kb, vk), jnp.asarray(vals),
                     jnp.asarray(idx))
    got = V.vsmm_plain(_torch_bf16(x), VectorSparse(
        _torch_bf16(vals), torch.from_numpy(idx), (kb * vk, nb * vn)),
        out_dtype=torch.float32)
    assert _rel(got.numpy(), ref) <= RTOL, name


def test_default_out_dtype_is_the_references():
    x, vals, idx = _operands(5, 8, 3, 4, 32, 108, 19)
    vs = VectorSparse(_torch_bf16(vals), torch.from_numpy(idx),
                      (19 * 32, 3 * 108))
    xt = _torch_bf16(x)
    y = V.vsmm_kernel(xt, vs)
    y32 = V.vsmm_kernel(xt, vs, out_dtype=torch.float32)
    assert y.dtype == torch.bfloat16 and y32.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16))
    ref = vsmm_pallas(jnp.asarray(x), RefVS(vals=jnp.asarray(vals),
                                            idx=jnp.asarray(idx),
                                            shape=vs.shape),
                      bm=8, interpret=True)
    assert ref.dtype == jnp.bfloat16
    i8 = V.vsmm_plain(torch.ones((8, 64), dtype=torch.int8), VectorSparse(
        torch.ones((2, 1, 32, 8), dtype=torch.int8),
        torch.zeros((2, 1), dtype=torch.int32), (64, 16)),
        scale=torch.ones(16))
    assert i8.dtype == torch.float32


def test_check_operands_takes_bf16_pairs_only_where_allowed():
    x = torch.zeros((8, 64), dtype=torch.bfloat16)
    vals = torch.zeros((2, 1, 32, 8), dtype=torch.bfloat16)
    idx = torch.zeros((2, 1), dtype=torch.int32)
    bias = torch.zeros(16)
    dev = torch.device("cpu")
    named = {"x": x, "vals": vals, "idx": idx, "bias": bias}
    assert V.check_operands(named, dev, bf16=True) is False
    with pytest.raises(ValueError, match="bfloat16"):
        V.check_operands({**named, "vals": vals.float()}, dev, bf16=True)
    with pytest.raises(ValueError, match="float32"):
        V.check_operands(named, dev)          # the conv kernels: no bf16
    with pytest.raises(ValueError, match="float32"):
        V.check_operands({**named, "bias": bias.bfloat16()}, dev, bf16=True)
    assert V.entry_name("vsmm_launch", False, True) == "vsmm_bf16_launch"
    assert V.entry_name("vsmm_launch", True) == "vsmm_int8_launch"
    assert V.entry_name("vsmm_launch", False) == "vsmm_launch"


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# name, M, NB, S, vk, vn, KB: the sparse FFN's tiles at full size
# (Qwen1.5-4B's wi gate and merged wo, Phi-3-medium's wi gate and merged
# wo) at decode (M 8) and prefill (M 1024) rows
GPU_SHAPES = [
    ("qwen wi", 64, 19, 32, 108, 80),
    ("qwen wo merged", 20, 64, 27, 128, 256),
    ("phi3 wi", 160, 38, 32, 112, 160),
    ("phi3 wo merged", 40, 128, 32, 128, 560),
]


def _cuda_operands(dev, seed, m, nb, s, vk, vn, kb, distinct=False):
    x, vals, idx = _operands(seed, m, nb, s, vk, vn, kb, distinct=distinct)
    return (_torch_bf16(x, dev), VectorSparse(
        _torch_bf16(vals, dev), torch.from_numpy(idx).to(dev),
        (kb * vk, nb * vn)))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("name,nb,s,vk,vn,kb", GPU_SHAPES)
def test_kernel_matches_plain_at_the_ffn_shapes(cuda, name, nb, s, vk, vn,
                                                kb, m):
    x, vs = _cuda_operands(cuda, 7, m, nb, s, vk, vn, kb)
    n0 = (V.vsmm_kernel.launches, V.vsmm_kernel.bf16_launches)
    y = V.vsmm_kernel(x, vs, out_dtype=torch.float32)
    assert (V.vsmm_kernel.launches - n0[0],
            V.vsmm_kernel.bf16_launches - n0[1]) == (1, 1)
    ref = V.vsmm_plain(x, vs, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    assert _rel(y.cpu(), ref.cpu()) <= RTOL, name
    again = V.vsmm_kernel(x, vs, out_dtype=torch.float32)
    assert torch.equal(y, again)
    off = V.vsmm_kernel(x, vs, out_dtype=torch.float32,
                        skip_zero_inputs=False)
    assert torch.equal(y, off)
    yb = V.vsmm_kernel(x, vs)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, y.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,vk,vn", [
    (8, 2560, 1728, 32, 108), (37, 864, 2560, 27, 128),
    (1024, 2560, 1728, 32, 108), (5, 512, 512, 32, 64)])
def test_kernel_on_pruned_weights_with_distinct_ids(cuda, m, k, n, vk, vn):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    pruned, mask = prune_vectors_balanced(w, 0.235, vk, vn)
    vs = from_mask(torch.from_numpy(pruned).bfloat16(), mask, vk, vn)
    vs = VectorSparse(vs.vals.to(cuda), vs.idx.to(cuda), vs.shape)
    assert not (vs.idx == vs.idx[:1]).all()
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).bfloat16().to(cuda)
    y = V.vsmm_kernel(x, vs, out_dtype=torch.float32)
    assert _rel(y.cpu(), V.vsmm_plain(x, vs, out_dtype=torch.float32).cpu()
                ) <= RTOL
    dense = decode(vs).float()
    assert _rel(y.cpu(), (x.float() @ dense).cpu()) <= RTOL


@pytest.mark.gpu
def test_skip_on_zero_and_negative_zero_tiles_is_bit_equal(cuda):
    """A post-ReLU-like input with whole K-tiles of +0.0 and -0.0: the
    vote skips both (as the reference's x != 0 does), bit-equal to the
    skip off and within 1e-5 of plain."""
    x, vs = _cuda_operands(cuda, 9, 24, 20, 64, 27, 128, 256)
    x = torch.relu(x.view(24, 256, 27))
    x[:, ::3] = 0.0
    x[:, 1::3] = -0.0
    x = x.reshape(24, -1).contiguous()
    on = V.vsmm_kernel(x, vs, out_dtype=torch.float32)
    off = V.vsmm_kernel(x, vs, out_dtype=torch.float32,
                        skip_zero_inputs=False)
    assert torch.equal(on, off)
    assert _rel(on.cpu(), V.vsmm_plain(x, vs, out_dtype=torch.float32
                                       ).cpu()) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 300])
def test_bf16_epilogue_and_split_plan(cuda, m):
    """Scale, bias, residual and ReLU fused (f32 operands) on the bf16
    branch, with a plan that splits the stored steps (few strips, many
    steps) at M 8 and 300."""
    x, vs = _cuda_operands(cuda, 13, m, 4, 96, 32, 128, 120, distinct=True)
    rows, splits = V.vsmm_bf16_plan(m, 4, 96, 32, 128)
    assert splits > 1
    n = vs.shape[1]
    g = torch.Generator(device=cuda).manual_seed(0)
    bias = torch.randn(n, device=cuda, generator=g)
    scale = torch.rand(n, device=cuda, generator=g) + 0.5
    res = torch.randn((m, n), device=cuda, generator=g)
    kw = dict(bias=bias, scale=scale, residual=res, fuse_relu=True,
              out_dtype=torch.float32)
    y = V.vsmm_kernel(x, vs, **kw)
    assert _rel(y.cpu(), V.vsmm_plain(x, vs, **kw).cpu()) <= RTOL
    assert torch.equal(y, V.vsmm_kernel(x, vs, **kw))
    yb = V.vsmm_kernel(x, vs, **{**kw, "out_dtype": torch.bfloat16})
    assert torch.equal(yb, y.to(torch.bfloat16))


@pytest.mark.gpu
def test_mixed_dtypes_raise_on_the_card(cuda):
    x, vs = _cuda_operands(cuda, 1, 8, 4, 3, 32, 128, 8)
    with pytest.raises(ValueError):
        V.vsmm_kernel(x.float(), vs)
    with pytest.raises(ValueError):
        V.vsmm_kernel(x, vs, bias=torch.zeros(512, dtype=torch.bfloat16,
                                              device=cuda))
    with pytest.raises(ValueError, match="f32 or bf16"):
        V.vsmm_kernel(x, vs, out_dtype=torch.float16)


# M, vk, vn, ids distinct across strips, epilogue and zero tiles: a
# covering subset of M (both tilings) x vk x vn
SWEEP = [
    (1, 27, 10, True, False), (5, 8, 108, False, True),
    (8, 16, 112, True, False), (8, 32, 64, False, True),
    (8, 27, 108, False, True), (9, 40, 128, True, True),
    (31, 64, 64, False, False), (31, 8, 10, True, True),
    (33, 27, 112, True, True), (64, 32, 10, False, True),
    (64, 27, 64, True, False), (100, 40, 108, True, False),
    (100, 64, 128, False, True), (1024, 8, 64, True, True),
    (1024, 64, 112, False, False), (1024, 32, 108, True, True),
    (4096, 27, 128, False, True), (4096, 16, 108, True, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("m,vk,vn,distinct,epi", SWEEP)
def test_sweep_of_m_vk_vn(cuda, m, vk, vn, distinct, epi):
    """Each case against plain (relative 1e-5), two launches bit-equal,
    skip off bit-equal to skip on, bf16 out the f32 out rounded."""
    nb, s, kb = 3, 5, 12
    x, vs = _cuda_operands(cuda, 100 + m + vk + vn, m, nb, s, vk, vn, kb,
                           distinct=distinct)
    kw = {}
    if epi:  # zero K-tiles (some -0.0) and the fused epilogue
        x3 = x.view(m, kb, vk)
        x3[:, ::4] = 0.0
        x3[:, 1::4] = -0.0
        g = torch.Generator(device=cuda).manual_seed(m)
        n = nb * vn
        kw = dict(bias=torch.randn(n, device=cuda, generator=g),
                  scale=torch.rand(n, device=cuda, generator=g) + 0.5,
                  residual=torch.randn((m, n), device=cuda, generator=g),
                  fuse_relu=True)
    y = V.vsmm_kernel(x, vs, out_dtype=torch.float32, **kw)
    ref = V.vsmm_plain(x, vs, out_dtype=torch.float32, **kw)
    assert _rel(y.cpu(), ref.cpu()) <= RTOL
    assert torch.equal(y, V.vsmm_kernel(x, vs, out_dtype=torch.float32,
                                        **kw))
    assert torch.equal(y, V.vsmm_kernel(x, vs, out_dtype=torch.float32,
                                        skip_zero_inputs=False, **kw))
    yb = V.vsmm_kernel(x, vs, out_dtype=torch.bfloat16, **kw)
    assert torch.equal(yb, y.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 1024])
def test_captured_replay_is_bit_equal_to_eager(cuda, m):
    """Qwen1.5-4B's merged wo shape (vk 27): split in two launches at M 8,
    one at 1024; the graph's replays on new inputs equal eager calls."""
    x, vs = _cuda_operands(cuda, 21, m, 20, 64, 27, 128, 256)
    assert (V.vsmm_bf16_plan(m, 20, 64, 27, 128)[1] > 1) == (m == 8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        V.vsmm_kernel(x, vs, out_dtype=torch.float32)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = V.vsmm_kernel(x, vs, out_dtype=torch.float32)
    for seed in (22, 23):
        x.copy_(_cuda_operands(cuda, seed, m, 20, 64, 27, 128, 256)[0])
        graph.replay()
        eager = V.vsmm_kernel(x, vs, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(y, eager)
