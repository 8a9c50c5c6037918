"""`vsmm_bf16_plan`: the tiling and split of vsmm's bf16 tensor-core body.

CPU tests: the plan is a pure function of the shapes; its row tile is
one of the body's (8, 16, 32 on the decode tiling, 64 on the prefill
one); its splits cut every strip's stored steps into non-empty chunks of
at least the tiling's fewest steps, and a split plan takes as many
chunks as its target of items allows (decode: the blocks the card holds;
prefill: the fewest that reach its target); the sparse FFN's products of
Qwen1.5-4B, Phi-3-medium and Nemotron-4 (shapes from `sparse_mlp_schema`,
``wo`` merged over the tp shards) at M 8, 1024 and 4096 take the tiling
and split the design names; the padding helper that `chip_smoke.py`'s
vk-27 staging comparison times (`chip_smoke._pad_vk`) gives the unpadded
product; the profile and build-log parsers file the bf16 kernels.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels import vsmm as V
from repro_torch.models.sparse_lm import sparse_mlp_schema


def _ffn_products(arch: str) -> dict:
    """(NB, S, vk, vn) of the sparse FFN's wi (one of gate / up) and its
    merged wo, at full width."""
    cfg = dataclasses.replace(get_config(arch), use_sparse_ffn=True)
    schema = sparse_mlp_schema(cfg, cfg.sparsity)
    wi = tuple(schema["wi_vals"].shape[-4:])
    tp, nb, s, vk, vn = schema["wo_vals"].shape
    return {"wi": wi, "wo": (nb, tp * s, vk, vn)}


SHAPES = {arch: _ffn_products(arch)
          for arch in ("qwen1.5-4b", "phi3-medium-14b", "nemotron-4-340b")}


def test_the_ffn_shapes_are_the_schemas():
    assert SHAPES["qwen1.5-4b"] == {"wi": (64, 19, 32, 108),
                                    "wo": (20, 64, 27, 128)}
    assert SHAPES["phi3-medium-14b"] == {"wi": (160, 38, 32, 112),
                                         "wo": (40, 128, 32, 128)}
    assert SHAPES["nemotron-4-340b"] == {"wi": (576, 135, 32, 128),
                                         "wo": (144, 544, 32, 128)}


# arch, product, M -> (rows, splits)
EXPECTED = {
    ("qwen1.5-4b", "wi", 8): (8, 9),          # NB 64: split to 576 items
    ("qwen1.5-4b", "wo", 8): (8, 32),
    ("phi3-medium-14b", "wi", 8): (8, 4),
    ("phi3-medium-14b", "wo", 8): (8, 16),
    ("nemotron-4-340b", "wi", 8): (8, 1),     # NB 576 fills the card
    ("nemotron-4-340b", "wo", 8): (8, 4),
    ("qwen1.5-4b", "wi", 1024): (64, 1),
    ("qwen1.5-4b", "wo", 1024): (64, 1),
    ("phi3-medium-14b", "wi", 1024): (64, 1),
    ("phi3-medium-14b", "wo", 1024): (64, 1),
    ("nemotron-4-340b", "wi", 1024): (64, 1),
    ("nemotron-4-340b", "wo", 1024): (64, 1),
    ("qwen1.5-4b", "wi", 4096): (64, 1),
    ("qwen1.5-4b", "wo", 4096): (64, 1),
    ("phi3-medium-14b", "wi", 4096): (64, 1),
    ("phi3-medium-14b", "wo", 4096): (64, 1),
    ("nemotron-4-340b", "wi", 4096): (64, 1),
    ("nemotron-4-340b", "wo", 4096): (64, 1),
}


@pytest.mark.parametrize("arch,product,m", sorted(EXPECTED))
def test_ffn_products_take_the_named_tiling(arch, product, m):
    nb, s, vk, vn = SHAPES[arch][product]
    rows, splits = V.vsmm_bf16_plan(m, nb, s, vk, vn)
    assert (rows, splits) == EXPECTED[(arch, product, m)]
    # M 8 (a decode step's batch) takes the swapped decode tiling, the
    # prefill rows the 64-row one
    assert (rows <= 32) == (m <= 32)
    _check_plan(m, nb, s, vk, vn)


def _check_plan(m, nb, s, vk, vn):
    rows, splits = V.vsmm_bf16_plan(m, nb, s, vk, vn)
    assert V.vsmm_bf16_plan(m, nb, s, vk, vn) == (rows, splits)  # pure
    assert rows in V.BF16_ROW_TILES
    assert rows == (8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32
                    else rows)
    assert (rows <= 32) == (m <= 32)
    assert 1 <= splits <= max(1, s)
    bounds = V.chunk_bounds(s, splits)
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    if s:
        assert all(b > a for a, b in bounds)  # every chunk non-empty
    if splits == 1:
        return
    least = (V.BF16_DECODE_MIN_CHUNK if rows <= 32
             else V.BF16_PREFILL_MIN_CHUNK)
    assert min(b - a for a, b in bounds) >= least
    items = nb * -(-m // rows)
    if rows <= 32:
        # as many chunks as the card holds blocks, or as the steps allow
        assert items * splits <= V.BF16_DECODE_ITEMS
        assert (items * (splits + 1) > V.BF16_DECODE_ITEMS
                or splits == s // least)
        return
    assert items < V.SMS  # prefill splits only where few items
    # the fewest chunks that reach the target, or as many as the steps
    # allow: within the target plus one round of items
    assert items * splits < V.TARGET_BLOCKS + items
    assert items * (splits - 1) < V.TARGET_BLOCKS
    assert items * splits >= V.TARGET_BLOCKS or splits == s // least


@pytest.mark.parametrize("m", [1, 5, 8, 9, 16, 17, 31, 32, 33, 63, 64, 100,
                               127, 128, 129, 1000, 1024, 4096, 100352])
@pytest.mark.parametrize("nb,s,vk,vn", [
    (1, 1, 32, 128), (1, 64, 27, 108), (3, 5, 8, 10), (4, 96, 32, 128),
    (20, 64, 27, 128), (64, 19, 32, 108), (576, 135, 32, 128),
    (2, 0, 16, 64), (7, 3, 40, 112), (144, 544, 32, 128)])
def test_plan_is_in_range_with_non_empty_chunks(m, nb, s, vk, vn):
    _check_plan(m, nb, s, vk, vn)


def test_plan_follows_the_shapes_not_vk_and_vn():
    for m in (8, 20, 300, 4096):
        plans = {V.vsmm_bf16_plan(m, 12, 40, vk, vn)
                 for vk in (8, 27, 64) for vn in (10, 108, 128)}
        assert len(plans) == 1


def test_split_plans_where_the_strips_are_few():
    # decode: a split wherever 2 NB <= BF16_DECODE_ITEMS and the steps allow
    assert V.vsmm_bf16_plan(8, 4, 96, 32, 128) == (8, 48)
    assert V.vsmm_bf16_plan(8, 4, 1, 32, 128) == (8, 1)
    assert V.vsmm_bf16_plan(8, 600, 40, 32, 128) == (8, 1)
    assert V.vsmm_bf16_plan(8, 300, 40, 32, 128) == (8, 2)
    assert V.vsmm_bf16_plan(8, 20, 64, 27, 128) == (8, 32)  # chunks of 2
    # prefill: 300 rows of 4 strips are 20 items of 64 rows
    assert V.vsmm_bf16_plan(300, 4, 96, 32, 128) == (64, 14)
    assert V.vsmm_bf16_plan(300, 40, 96, 32, 128) == (64, 1)


@pytest.mark.parametrize("m,kb,nb,s,vk,vn", [
    (8, 9, 3, 4, 27, 128), (13, 6, 2, 5, 27, 108), (5, 4, 2, 3, 5, 7)])
def test_pad_vk_gives_the_unpadded_product(m, kb, nb, s, vk, vn):
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(np.stack([np.sort(rng.choice(kb, s, replace=False))
                                     for _ in range(nb)]).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((nb, s, vk, vn)).astype(
        np.float32)).bfloat16()
    x = torch.from_numpy(rng.standard_normal((m, kb * vk)).astype(
        np.float32)).bfloat16()
    vs = VectorSparse(vals, idx, (kb * vk, nb * vn))
    xp, wp = chip_smoke._pad_vk(x, vs, 32)
    assert xp.shape == (m, kb * 32) and wp.vals.shape == (nb, s, 32, vn)
    assert wp.shape == (kb * 32, nb * vn) and xp.is_contiguous()
    assert torch.equal(wp.vals[:, :, vk:], torch.zeros_like(wp.vals[:, :, vk:]))
    ref = V.vsmm_plain(x, vs, out_dtype=torch.float32)
    got = V.vsmm_plain(xp, wp, out_dtype=torch.float32)
    assert torch.allclose(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


_MM = "_ZN12_GLOBAL__N__2b3c4d5e_7_vsmm_cu_6f7a8b9c"


def test_profile_and_build_log_file_the_bf16_kernels():
    for rows in (8, 64):
        name = f"{_MM}16vsmm_bf16_kernelILi{rows}EEEvPK13__nv_bfloat16"
        assert chip_smoke._kind(name) == "vsmm"
        assert chip_smoke._vsmm_row(name) == {"kernel": "vsmm_bf16",
                                              "rows": rows}
    assert chip_smoke._vsmm_row(f"{_MM}11vsmm_kernelILi8EEEvPKf") == {
        "kernel": "vsmm", "rt": 8}
