"""Deterministic synthetic data pipeline.

The port of `repro/data/pipeline.py`: the same numpy code, kept as its
own copy (the port imports nothing of the JAX package), so a batch is
bit-equal to the reference's for any (seed, step, shard).  Batches are
numpy arrays; the trainer moves them to its device.

Design goals that matter at cluster scale even for synthetic data:
  * deterministic per (seed, step, shard) — restarting at step k reproduces
    exactly the stream a non-failed run would have seen ("skip-to-step"),
  * shard-aware — each data shard materializes only its slice,
  * zero host I/O — everything derives from counter-based RNG.

Token streams get a Zipf marginal and short-range repetition structure so
losses and activation sparsity behave like text rather than white noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LMBatchSpec", "SyntheticLM", "SyntheticImages", "SyntheticEmbeds"]


@dataclasses.dataclass(frozen=True)
class LMBatchSpec:
    global_batch: int
    seq_len: int
    vocab: int
    n_shards: int = 1
    shard: int = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


class SyntheticLM:
    """Next-token LM batches: {'tokens', 'labels'} int32 (local_batch, seq)."""

    def __init__(self, spec: LMBatchSpec, seed: int = 0):
        self.spec = spec
        self.seed = seed

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.spec.shard])
        )

    def batch_at(self, step: int) -> dict:
        sp = self.spec
        rng = self._rng(step)
        # Zipf-ish marginals + repeated n-grams (compressible structure)
        u = rng.random((sp.local_batch, sp.seq_len + 1))
        stream = np.floor(np.exp(u * np.log(sp.vocab))).astype(np.int64) - 1
        # splice in repeats: copy a random earlier window forward
        for b in range(sp.local_batch):
            if sp.seq_len < 48:  # too short for the splice window math
                continue
            src = rng.integers(0, sp.seq_len // 2)
            dst = rng.integers(sp.seq_len // 2, sp.seq_len - 16)
            ln = rng.integers(8, 16)
            stream[b, dst : dst + ln] = stream[b, src : src + ln]
        stream = np.clip(stream, 0, sp.vocab - 1).astype(np.int32)
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class SyntheticEmbeds:
    """Frontend-stub batches: {'embeds' (B, T, D) f32, 'labels' (B, T) i32}."""

    def __init__(self, spec: LMBatchSpec, d_model: int, seed: int = 0):
        self.spec = spec
        self.d_model = d_model
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        sp = self.spec
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, sp.shard, 1])
        )
        basis = np.random.default_rng(self.seed).standard_normal(
            (16, self.d_model), np.float32
        )
        coef = rng.standard_normal((sp.local_batch, sp.seq_len, 16), np.float32)
        noise = rng.standard_normal(
            (sp.local_batch, sp.seq_len, self.d_model), np.float32
        )
        embeds = (coef @ basis) / 4.0 + 0.5 * noise
        labels = rng.integers(
            0, sp.vocab, (sp.local_batch, sp.seq_len), dtype=np.int32
        )
        return {"embeds": embeds, "labels": labels}


class SyntheticImages:
    """Natural-image-statistics batches for the CNN path: 1/f spectrum images
    (so post-ReLU activation sparsity resembles real VGG traffic, which the
    paper's input-side skipping depends on)."""

    def __init__(self, batch: int, size: int = 224, classes: int = 1000,
                 seed: int = 0):
        self.batch, self.size, self.classes, self.seed = batch, size, classes, seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        n, s = self.batch, self.size
        freqs = np.fft.fftfreq(s)
        fx, fy = np.meshgrid(freqs, freqs)
        amp = 1.0 / np.maximum(np.sqrt(fx**2 + fy**2), 1.0 / s)
        spec = (
            rng.standard_normal((n, s, s, 3)) + 1j * rng.standard_normal((n, s, s, 3))
        ) * amp[None, :, :, None]
        img = np.fft.ifft2(spec, axes=(1, 2)).real
        img = (img - img.mean(axis=(1, 2, 3), keepdims=True)) / (
            img.std(axis=(1, 2, 3), keepdims=True) + 1e-6
        )
        labels = rng.integers(0, self.classes, (n,), dtype=np.int32)
        return {"images": img.astype(np.float32), "labels": labels}
