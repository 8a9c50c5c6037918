"""Chunked cross-entropy over the padded vocabulary.

The port of `repro/parallel/losses.py` on one device (its `logical`
sharding constraints, which only its training under a mesh reads, are
not ported yet).  Never materializes the
whole (batch, seq, vocab) logits: the sequence is taken in ``chunk``-sized
slices, each projected onto the (embed, vocab) output matrix.  Padded
vocab entries (vocab rounded up for even sharding) are masked out.

Precision: the reference takes h and the unembedding to f32 before the
product.  A bf16 value is exact in f32, so the port's product is
`layers.matmul_f32` (on the card one ``mm`` with an f32 output over the
bf16 operands, and a backward that sums in f32): no f32 copy of the
(D, Vp) matrix stays alive across chunks.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import matmul_f32

__all__ = ["chunked_cross_entropy", "cross_entropy_dense"]


def _chunk_ce(h: torch.Tensor, labels: torch.Tensor, w_out: torch.Tensor, *,
              real_vocab: int, z_weight: float) -> torch.Tensor:
    """h (B, C, D) f32/bf16, labels (B, C) int, w_out (D, Vp) -> (B, C)
    token NLL in f32."""
    logits = matmul_f32(h, w_out)
    vp = w_out.shape[1]
    if real_vocab != vp:
        pad = torch.arange(vp, device=h.device) >= real_vocab
        logits = torch.where(pad, -1e30, logits)
    # the max is held out of the gradient (the reference's stop_gradient)
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_weight:
        nll = nll + z_weight * torch.square(lse)  # z-loss (logit drift)
    return nll


def chunked_cross_entropy(h: torch.Tensor, labels: torch.Tensor,
                          w_out: torch.Tensor, *, real_vocab: int,
                          chunk: int = 512, z_weight: float = 0.0,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL of h (B, T, D) against labels (B, T) via w_out
    (D, Vp): a 0-d f32 tensor.  ``mask`` (B, T) bool keeps the tokens
    that count (all of them by default).

    T is taken in ``chunk``-sized slices (the last one zero-padded and
    masked), so the largest logits block is (B, chunk, Vp); the sums run
    over the chunks in order, as the reference's scan runs them.
    """
    b, t, _ = h.shape
    chunk = min(chunk, t)
    if mask is None:
        mask = torch.ones((b, t), dtype=torch.bool, device=h.device)
    if t % chunk:
        pad = chunk - t % chunk
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        mc = mask[:, c0:c0 + chunk].float()
        nll = _chunk_ce(h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                        w_out, real_vocab=real_vocab, z_weight=z_weight)
        total = total + torch.sum(nll * mc)
        count = count + torch.sum(mc)
    return total / torch.clamp_min(count, 1.0)


def cross_entropy_dense(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Plain CE for small-vocab models (a CNN classifier, smoke tests)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -torch.mean(gold)
