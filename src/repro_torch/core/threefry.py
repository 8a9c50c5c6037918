"""The reference's counter-based PRNG: threefry2x32, its keys and draws.

The reference samples with threefry2x32 keys in its partitionable mode
(the mode its installed version runs by default).  This module gives the
same bits:

* `prng_key(seed)`: the key of an integer seed with 64-bit types off —
  (0, seed mod 2^32);
* `fold_in(key, data)`: threefry2x32 of the key over the counter pair
  (0, data mod 2^32); `split(key, n)`: the n keys fold_in(key, i) — the
  partitionable split draws key i from the counter (0, i) as fold_in
  does;
* `random_bits(keys, n)`: 32 bits for each of n counters under each key —
  counter i is the pair (i >> 32, i mod 2^32) and the bits are the xor
  of the two output words;
* `uniform(bits, lo, hi)`: floats in [lo, hi): the bits' top 23 as the
  mantissa of a float in [1, 2), minus 1, scaled by (hi - lo), plus lo
  (one rounding, as the reference's fused multiply-add), and at least
  lo — the reference's float conversion for f32;
* `gumbel(keys, n)`: -log(-log(u)) of uniform draws in [tiny, 1);
* `normal(key, shape)`: sqrt(2) erfinv(u) of uniform draws in
  (-1, 1), the reference's f32 normal: the same u, bit for bit; each
  value within 2 ulps of sqrt(2) erfinv(u) taken in f64, where the
  reference's own ``erf_inv`` approximation is off by up to ~90 ulps in
  the tails (|x| near 3.8), so the two agree to ~6e-6 relative.

`threefry2x32` runs on Python ints (keys, a scalar per call) and on
int64 tensors holding uint32 values (the draws, on the logits' device),
with every sum and shift masked back to 32 bits: PyTorch has no uint32
arithmetic to lean on.
"""
from __future__ import annotations

import torch

__all__ = ["MASK", "threefry2x32", "prng_key", "fold_in", "split",
           "random_bits", "uniform", "gumbel", "normal"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2); Python ints or int64 tensors of uint32
    values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed: int) -> tuple[int, int]:
    """The key of an integer seed (64-bit types off: the seed's low 32
    bits, high word 0)."""
    return 0, seed & MASK


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """A new key from ``key`` and 32 bits of ``data``."""
    return threefry2x32(key[0], key[1], 0, data & MASK)


def split(key: tuple[int, int], n: int) -> list[tuple[int, int]]:
    """``n`` new keys from ``key`` (the partitionable split)."""
    return [fold_in(key, i) for i in range(n)]


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """keys (B, 2) int64 -> (B, n) int64: 32 random bits per counter
    0..n-1 under each key, drawn on the keys' device."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    hi, lo = threefry2x32(keys[:, :1], keys[:, 1:], i >> 32, i & MASK)
    return hi ^ lo


def uniform(bits: torch.Tensor, lo: float = 0.0,
            hi: float = 1.0) -> torch.Tensor:
    """32-bit draws (int64 holding uint32) -> f32 uniform in [lo, hi).

    The reference's compiler fuses the scale and the shift into one
    multiply-add, rounded once: the product of two f32 values is exact
    in f64, so the f64 sum rounded to f32 gives its bits (where the span
    is a power of two, as for [tiny, 1) and (-1, 1), either way does)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo_t = torch.full((), lo, dtype=torch.float32, device=bits.device)
    span = torch.full((), hi, dtype=torch.float32, device=bits.device) - lo_t
    y = ((mant - 1.0).double() * span.double() + lo_t.double()).float()
    return torch.maximum(lo_t, y)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """keys (B, 2) int64 -> (B, n) f32 standard Gumbel noise, from
    uniform draws in [tiny, 1) (the reference's low-range mode)."""
    u = uniform(random_bits(keys, n), _TINY)
    return -torch.log(-torch.log(u))


_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0),
                                   torch.tensor(0.0)).item())


def normal(key: tuple[int, int], shape: tuple[int, ...],
           device: torch.device | str = "cpu") -> torch.Tensor:
    """f32 standard normals of ``shape`` under ``key``, drawn on
    ``device``: counter i is the row-major flat index."""
    n = 1
    for d in shape:
        n *= d
    keys = torch.tensor([key], dtype=torch.int64, device=device)
    u = uniform(random_bits(keys, n)[0], _NORMAL_LO, 1.0)
    sqrt2 = torch.full((), 2.0, dtype=torch.float32, device=device).sqrt()
    return (sqrt2 * torch.erfinv(u)).reshape(shape)
