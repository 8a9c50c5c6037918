"""Modality frontend stubs: synthetic inputs for the embedding-input archs.

The port of `repro/models/frontend.py`.  The InternVL2 (InternViT) and
HuBERT (conv feature encoder) frontends are stubs in the reference too:
those archs take precomputed patch or frame embeddings (B, T, d_model)
(``embed_inputs=False``), and these helpers draw deterministic
synthetic ones.  Keys are the reference's threefry keys
(`core.threefry`: ``prng_key(seed)``), split as the reference splits
them, so one key gives the reference's arrays: the uniform bits equal;
the tokens and labels equal but where exp(u log V) lies within an ulp of
an integer, where the two libraries' exp may floor to neighbours (6 of
120,000 ids over 20 seeds and three vocabularies); the normals within
~6e-6 relative of the reference's (`threefry.normal`: its ``erf_inv``
is the less exact of the two), and the embeddings' 16-term products
summed in another order: in f32 within 1e-5 of max|x|, a bf16 value now
and then one ulp off.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import threefry

__all__ = ["synthetic_embeddings", "synthetic_tokens", "synthetic_labels"]


def synthetic_embeddings(key: tuple[int, int], batch: int, seq: int,
                         d_model: int, dtype: torch.dtype = torch.bfloat16,
                         device: torch.device | str = "cpu"
                         ) -> torch.Tensor:
    """Unit-variance embeddings with a shared low-rank structure (so the
    sequence is not white noise: attention has something to attend to),
    drawn on ``device``."""
    k1, k2, k3 = threefry.split(key, 3)
    basis = threefry.normal(k1, (16, d_model), device)
    coef = threefry.normal(k2, (batch, seq, 16), device) / 4.0
    noise = threefry.normal(k3, (batch, seq, d_model), device)
    return (coef @ basis + 0.5 * noise).to(dtype)


def synthetic_tokens(key: tuple[int, int], batch: int, seq: int, vocab: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """(batch, seq) int32 token ids with a Zipf-like marginal."""
    keys = torch.tensor([key], dtype=torch.int64, device=device)
    u = threefry.uniform(threefry.random_bits(keys, batch * seq)[0], 1e-6,
                         1.0).reshape(batch, seq)
    log_v = torch.full((), math.log(float(vocab)), dtype=torch.float32,
                       device=device)
    ranks = torch.floor(torch.exp(u * log_v)) - 1
    return torch.clamp(ranks.to(torch.int32), 0, vocab - 1)


def synthetic_labels(key: tuple[int, int], batch: int, seq: int, vocab: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    return synthetic_tokens(threefry.fold_in(key, 1), batch, seq, vocab,
                            device)
