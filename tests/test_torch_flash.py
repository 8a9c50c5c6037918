"""The flash kernel's plain version against the JAX reference, on the CPU.

`flash_fwd_plain` (what `flash_fwd_kernel` runs on a CPU tensor, and what
the CUDA kernel is held against on the card) against the reference's
Pallas kernel `flash_fwd_pallas` in interpret mode, on the same numpy
inputs.  The port's (B, T, H, hd) `flash_attention` and `repeat_kv`
against `repro.models.attention`'s.

Tolerance: relative 1e-5 of max|y| in f32 (the same online-softmax chain;
the port's plain version uses the blocks `_flash_pallas` picks, 256 / 512,
where the reference cases pick smaller ones, so only the order of the f32
sums differs), 1e-2 in bf16 (p is rounded to bf16 at another running max
when the blocks differ).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash_fwd_pallas
from repro.models import attention as RA
from repro_torch.kernels import flash as TF
from repro_torch.models import attention as TA

RTOL = 1e-5


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _qkv(rng, bh, tq, tk, hd, scale=1.0):
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in ((bh, tq, hd), (bh, tk, hd), (bh, tk, hd))]


# the four cases of the reference's TestFlashKernel.test_matches_naive, and
# a head dim of 240 (Gemma-3's) with a window
CASES = [
    dict(bh=4, tq=128, tk=128, hd=64, bq=32, bk=32, causal=True),
    dict(bh=2, tq=64, tk=128, hd=32, bq=32, bk=64, causal=False),
    dict(bh=2, tq=128, tk=128, hd=64, bq=64, bk=32, causal=True, window=16),
    dict(bh=1, tq=32, tk=256, hd=64, bq=32, bk=64, causal=True, q_offset=224),
    dict(bh=2, tq=64, tk=64, hd=240, bq=32, bk=32, causal=True, window=24),
    # shapes the GPU tests give the kernel's bf16 body: one query at the
    # end, hd 20 (padded to 32 there), fewer keys than one kv tile
    dict(bh=2, tq=1, tk=40, hd=128, bq=1, bk=40, causal=True, q_offset=39),
    dict(bh=3, tq=70, tk=70, hd=20, bq=70, bk=70, causal=True),
    dict(bh=2, tq=50, tk=37, hd=64, bq=50, bk=37, causal=False),
]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_the_pallas_kernel(case):
    rng = np.random.default_rng(case["tk"] + case["hd"])
    q, k, v = _qkv(rng, case["bh"], case["tq"], case["tk"], case["hd"])
    mask = {n: case[n] for n in ("causal", "window", "q_offset")
            if n in case}
    ref = flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           bq=case["bq"], bk=case["bk"], interpret=True,
                           **mask)
    got = TF.flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **mask)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _rel(got, ref) <= RTOL
    # the wrapper on a CPU tensor is the plain version, and no launch
    before = TF.flash_fwd_kernel.launches
    wrapped = TF.flash_fwd_kernel(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **mask)
    assert torch.equal(wrapped, got)
    assert TF.flash_fwd_kernel.launches == before


def test_plain_matches_the_pallas_kernel_in_bf16():
    """p is rounded to bf16 before the PV product, the output to bf16."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 64, 64, 128)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = flash_fwd_pallas(*jb, bq=32, bk=32, interpret=True)
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in jb]
    got = TF.flash_fwd_plain(*tb)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), np.asarray(ref, np.float32)) <= 1e-2


def test_plain_is_finite_at_large_logits():
    """The reference's large-logit case: -1e30 masking and the running max
    keep every output finite."""
    rng = np.random.default_rng(8)
    q, k, _ = _qkv(rng, 1, 32, 32, 32, scale=80.0)
    v = rng.standard_normal((1, 32, 32)).astype(np.float32)
    got = TF.flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v))
    ref = flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           bq=16, bk=16, interpret=True)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= RTOL


def test_kernel_body_names_the_body_each_dtype_runs():
    assert TF.kernel_body(torch.bfloat16) == "mma"
    assert TF.kernel_body(torch.float32) == "simt"


def test_chunk_size_is_the_references():
    for t in (1, 7, 24, 33, 256, 512, 528, 1000, 2048):
        for pref in (256, 512):
            assert TF.chunk_size(t, pref) == RA._chunk_sizes(t, pref)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 8)])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_flash_attention_and_repeat_kv_match_the_reference(causal, window,
                                                           kv_heads):
    rng = np.random.default_rng(9 + kv_heads)
    b, t, h, hd = 2, 40, 4, 32
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv_heads, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv_heads, hd)).astype(np.float32)
    kr_ref = RA.repeat_kv(jnp.asarray(k), h)
    vr_ref = RA.repeat_kv(jnp.asarray(v), h)
    kr = TA.repeat_kv(torch.from_numpy(k), h)
    vr = TA.repeat_kv(torch.from_numpy(v), h)
    np.testing.assert_array_equal(kr.numpy(), np.asarray(kr_ref))
    ref = RA.flash_attention(jnp.asarray(q), kr_ref, vr_ref, causal=causal,
                             window=window, bq=8, bk=16)
    got = TA.flash_attention(torch.from_numpy(q), kr, vr, causal=causal,
                             window=window)
    assert got.shape == (b, t, h, hd)
    assert _rel(got, ref) <= RTOL


@pytest.mark.parametrize("bad,match", [
    (dict(hd=30), "multiple of 4"),
    (dict(hd=260), "multiple of 4"),
    (dict(tk=0), "at least one key"),
    (dict(window=0), "window"),
    (dict(q_offset=-1), "q_offset"),
    (dict(k_dtype=torch.float64), "float32 or bfloat16"),
    (dict(q_dtype=torch.float16, k_dtype=torch.float16), "float32 or"),
    (dict(noncontig=True), "contiguous"),
    (dict(k_bh=3), "expected"),
])
def test_kernel_operand_checks_raise(bad, match):
    """What the CUDA wrapper checks before a launch, run on CPU tensors."""
    hd, tk = bad.get("hd", 32), bad.get("tk", 16)
    q = torch.zeros(2, 8, hd, dtype=bad.get("q_dtype", torch.float32))
    k = torch.zeros(bad.get("k_bh", 2), tk, hd,
                    dtype=bad.get("k_dtype", torch.float32))
    v = torch.zeros_like(k)
    if bad.get("noncontig"):
        k = torch.zeros(2, hd, tk).transpose(1, 2)
        v = torch.zeros_like(k)
    with pytest.raises(ValueError, match=match):
        TF._check(q, k, v, bad.get("window"), bad.get("q_offset", 0))


def test_kernel_refuses_other_devices():
    # meta is the dry run's abstract device (the kernel's fake
    # implementation, `tests/test_torch_cost.py`); any other is refused
    q = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        TF.flash_fwd_kernel(q, q, q)
