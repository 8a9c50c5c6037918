"""Vocab-sharded, chunked cross-entropy over the padded vocabulary.

The port of `repro/parallel/losses.py`.  Never materializes the
whole (batch, seq, vocab) logits: the sequence is taken in ``chunk``-sized
slices, each projected onto the (embed, vocab) output matrix.  Padded
vocab entries (vocab rounded up for even sharding) are masked out.

Under a mesh (`parallel.sharding.use_mesh`, ``h`` a DTensor) each rank
takes its batch rows of ``h`` against its vocab columns of ``w_out``
(the reference's ``logical(logits, ("batch", None, "vocab"))``): per
chunk the local logits (B/dp, C, Vp/tp), the max over the vocab's mesh
dims (held out of the gradient), the exponentials summed over them, the
gold logit from the rank whose columns hold it, the padded-vocab mask by
the *global* vocab index; the token sums are then summed over the batch
dims.  The full logits are never gathered.  Where the vocab stays whole
on every rank the chunk is the mesh-free one, op for op.

Precision: the reference takes h and the unembedding to f32 before the
product.  A bf16 value is exact in f32, so the port's product is
`layers.matmul_f32` (on the card one ``mm`` with an f32 output over the
bf16 operands, and a backward that sums in f32): no f32 copy of the
(D, Vp) matrix stays alive across chunks.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import matmul_f32
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import PartitionSpec

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


def _chunk_ce_vocab(h: torch.Tensor, labels: torch.Tensor,
                    w_out: torch.Tensor, *, real_vocab: int,
                    z_weight: float, v0: int, entry) -> torch.Tensor:
    """`_chunk_ce` on this rank's vocab columns [v0, v0 + Vl) of a vocab
    split over the mesh dims ``entry``: (B, C) token NLL in f32, the same
    on every rank along ``entry``."""
    logits = matmul_f32(h, w_out)
    vl = w_out.shape[1]
    if v0 + vl > real_vocab:  # padded columns, by their global index
        pad = torch.arange(v0, v0 + vl, device=h.device) >= real_vocab
        logits = torch.where(pad, -1e30, logits)
    m = shd.all_reduce(logits.amax(dim=-1, keepdim=True).detach(), entry,
                       "max")
    lse = torch.log(shd.all_reduce(torch.exp(logits - m).sum(dim=-1),
                                   entry)) + m[..., 0]
    at = labels.long() - v0
    mine = (at >= 0) & (at < vl)
    gold = torch.gather(logits, -1, at.clamp(0, vl - 1)[..., None])[..., 0]
    gold = shd.all_reduce(torch.where(mine, gold, 0.0), entry)
    nll = lse - gold
    if z_weight:
        nll = nll + z_weight * torch.square(lse)
    return nll


def _ce_sums(h: torch.Tensor, labels: torch.Tensor, w_out: torch.Tensor,
             mask: torch.Tensor | None, chunk: int, chunk_ce
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the kept tokens' NLL, their count), 0-d f32: the chunks in
    order, the last one zero-padded and masked."""
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
        nll = chunk_ce(h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], w_out)
        total = total + torch.sum(nll * mc)
        count = count + torch.sum(mc)
    return total, count


def chunked_cross_entropy(h: torch.Tensor, labels: torch.Tensor,
                          w_out: torch.Tensor, *, real_vocab: int,
                          chunk: int = 512, z_weight: float = 0.0,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL of h (B, T, D) against labels (B, T) via w_out
    (D, Vp): a 0-d f32 tensor.  ``mask`` (B, T) bool keeps the tokens
    that count (all of them by default).

    T is taken in ``chunk``-sized slices (the last one zero-padded and
    masked), so the largest logits block is (B, chunk, Vp); the sums run
    over the chunks in order, as the reference's scan runs them.  Under
    a mesh (``h`` a DTensor) see `_chunked_ce_mesh`: a replicated 0-d
    DTensor.
    """
    if shd.current() is not None and isinstance(h, DTensor):
        return _chunked_ce_mesh(h, labels, w_out, real_vocab=real_vocab,
                                chunk=chunk, z_weight=z_weight, mask=mask)
    total, count = _ce_sums(
        h, labels, w_out, mask, chunk,
        lambda hc, lc, w: _chunk_ce(hc, lc, w, real_vocab=real_vocab,
                                    z_weight=z_weight))
    return total / torch.clamp_min(count, 1.0)


def _chunked_ce_mesh(h: DTensor, labels: DTensor, w_out: DTensor, *,
                     real_vocab: int, chunk: int, z_weight: float,
                     mask: DTensor | None) -> DTensor:
    """The loss on each rank's batch rows and vocab columns: local token
    sums (`_chunk_ce_vocab`, or the mesh-free chunk where the vocab is
    whole), summed over the batch dims; the mean as a replicated 0-d
    DTensor."""
    ctx = shd.current()
    b, t, d = h.shape
    b_entry = shd.spec_for(("batch", None), mesh=ctx.mesh, rules=ctx.rules,
                           shape=(b, t))[0]
    v_entry = shd.spec_for((None, "vocab"), mesh=ctx.mesh, rules=ctx.rules,
                           shape=tuple(w_out.shape))[1]
    hl = shd.local_spec(h, PartitionSpec(b_entry, None, None))
    ll = shd.local_spec(labels, PartitionSpec(b_entry, None))
    ml = None if mask is None else shd.local_spec(
        mask, PartitionSpec(b_entry, None))
    wl = shd.local_spec(w_out, PartitionSpec(None, v_entry))
    if shd.axis_size(v_entry) == 1:
        def chunk_ce(hc, lc, w):
            return _chunk_ce(hc, lc, w, real_vocab=real_vocab,
                             z_weight=z_weight)
    else:
        v0 = shd.axis_index(v_entry) * wl.shape[1]

        def chunk_ce(hc, lc, w):
            return _chunk_ce_vocab(hc, lc, w, real_vocab=real_vocab,
                                   z_weight=z_weight, v0=v0, entry=v_entry)
    total, count = _ce_sums(hl, ll, wl, ml, chunk, chunk_ce)
    total = shd.all_reduce(total, b_entry)
    count = shd.all_reduce(count, b_entry)
    return shd.from_local_spec(total / torch.clamp_min(count, 1.0),
                               PartitionSpec(), ())


def cross_entropy_dense(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Plain CE for small-vocab models (a CNN classifier, smoke tests)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -torch.mean(gold)
