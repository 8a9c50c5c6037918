"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``reference/<name>.py``) makes the weights again from the
seed, prepares them itself (BN folding, the frozen balanced pruning) and
computes, in f32 with TF32 off, the logits of a sample of the delivered
requests, in blocks of rows.  The sample is drawn from the seed: a
reservoir of `SAMPLE` requests over all deliveries, plus the first request
served in each wave shape.  Each sampled request's served logits are
compared with the reference's: ``logit_rel_err`` is the largest
``max |served - ref| / max |ref|`` over the sample.  A request due in the
window that is never delivered counts in ``undelivered``.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from portbench.harness.data import make_params, stream_seed
from portbench.reference.common import geometry, precision, prepare, schema

__all__ = ["SAMPLE", "Sampler", "ref_layers", "kept_share",
           "reference_logits", "logit_rel_err"]

SAMPLE = 256
BLOCK = 32      # rows of one reference forward


class Sampler:
    """A seeded reservoir of delivered requests, plus the first of each
    wave shape: {key: (image index, logits)}."""

    def __init__(self, seed: int, k: int = SAMPLE):
        self.rng = np.random.default_rng(stream_seed(seed, "sample"))
        self.k = k
        self.seen = 0
        self.reservoir: list = []
        self.by_shape: dict = {}

    def offer(self, image: int, logits: np.ndarray, shape: int) -> None:
        item = (image, np.array(logits, np.float32, copy=True))
        if shape not in self.by_shape:
            self.by_shape[shape] = item
        if self.seen < self.k:
            self.reservoir.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.reservoir[j] = item
        self.seen += 1

    def items(self) -> list:
        return self.reservoir + [self.by_shape[s]
                                 for s in sorted(self.by_shape)]


def ref_layers(config: dict, ref: Any) -> list:
    return ref.layer_table(config["image_size"], config["num_classes"])


def kept_share(config: dict, layers: list) -> dict:
    """{layer: the share of its weights that pruning keeps}."""
    out = {}
    for l in layers:
        g = geometry(l, vk=config["vk"], vn=config["vn"])
        pruned = g is not None and g.prune and config["weight_density"] < 1
        out[l.name] = config["weight_density"] if pruned else 1.0
    return out


def reference_logits(config: dict, ref: Any, seed: int, images: np.ndarray,
                     device: Any, *, tf32: tuple = (False,)) -> list:
    """The reference's logits of ``images`` (N, H, W, C), the weights made
    again from ``seed``: one array for each setting in ``tf32`` (False:
    f32 matmuls and convolutions; True: TF32, the control)."""
    layers = ref_layers(config, ref)
    params = make_params(schema(layers), seed, device,
                         kept=kept_share(config, layers))
    prep = prepare(layers, params, config["weight_density"],
                   vk=config["vk"], vn=config["vn"], device=device)
    del params
    outs = []
    for flag in tf32:
        out = []
        with precision(flag), torch.inference_mode():
            for i in range(0, len(images), BLOCK):
                x = torch.from_numpy(
                    np.ascontiguousarray(images[i:i + BLOCK]))
                x = x.to(device).permute(0, 3, 1, 2).contiguous()
                out.append(ref.forward(layers, prep, x).float().cpu()
                           .numpy())
        outs.append(np.concatenate(out))
    return outs


def logit_rel_err(served: np.ndarray, ref: np.ndarray) -> float:
    """The largest over rows of max |served - ref| / max |ref|; inf where
    a row is not finite or has the wrong width."""
    if served.shape != ref.shape or not np.isfinite(served).all():
        return math.inf
    d = np.abs(served.astype(np.float64) - ref).max(axis=1)
    s = np.abs(ref.astype(np.float64)).max(axis=1)
    return float((d / np.maximum(s, 1e-30)).max())
