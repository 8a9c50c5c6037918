"""Weights and images made from ``--seed``, on the device, in a few large
calls.

Conv and FC weights are normal with He's variance for the layer's kept
share: std = sqrt(2 / (fan_in * kept)), ``kept`` the configuration's
density for a pruned layer and 1 otherwise, so that activations keep their
scale through the pruned net.  Biases are N(0, 0.01^2).  BN leaves are
uniform: scale in [0.5, 1.5], offset and mean in [-0.1, 0.1], var in
[0.5, 1.5], so that folding them changes every weight.  Images are
N(0, 1), the statistics of ImageNet-normalised inputs.  Every stream has
its own generator, seeded from ``--seed`` and the stream's name.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any

import numpy as np
import torch

__all__ = ["stream_seed", "make_params", "make_images"]

_UNIFORM = {"scale": (0.5, 1.5), "offset": (-0.1, 0.1),
            "mean": (-0.1, 0.1), "var": (0.5, 1.5)}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of the run's data."""
    h = hashlib.sha256(f"{seed}/{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _generator(seed: int, stream: str, device: torch.device
               ) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def make_params(schema: dict, seed: int, device: Any, *,
                kept: dict) -> dict:
    """{layer: {leaf: f32 tensor}} to ``schema`` ({layer: {leaf: shape}}):
    one normal draw for every weight and bias, one uniform draw for every
    BN leaf.  ``kept`` maps each layer to the share of its weights that
    pruning keeps (1 for a dense layer)."""
    device = torch.device(device)
    normal, uniform = [], []
    for layer, leaves in schema.items():
        for leaf, shape in leaves.items():
            (uniform if leaf in _UNIFORM else normal).append(
                (layer, leaf, tuple(shape)))
    n_norm = sum(math.prod(s) for _, _, s in normal)
    n_unif = sum(math.prod(s) for _, _, s in uniform)
    z = torch.randn(n_norm, generator=_generator(seed, "weights", device),
                    device=device)
    u = torch.rand(n_unif, generator=_generator(seed, "bn", device),
                   device=device)
    out: dict = {layer: {} for layer in schema}
    at = 0
    for layer, leaf, shape in normal:
        n = math.prod(shape)
        t = z[at:at + n].view(shape)
        at += n
        if leaf == "w":
            fan_in = math.prod(shape[:-1])
            t.mul_(math.sqrt(2.0 / (fan_in * kept[layer])))
        else:
            t.mul_(0.01)
        out[layer][leaf] = t
    at = 0
    for layer, leaf, shape in uniform:
        n = math.prod(shape)
        lo, hi = _UNIFORM[leaf]
        out[layer][leaf] = u[at:at + n].view(shape).mul_(hi - lo).add_(lo)
        at += n
    return out


def make_images(seed: int, n: int, size: int, channels: int,
                device: Any) -> np.ndarray:
    """``n`` distinct (size, size, channels) f32 images on the host, drawn
    on ``device`` in one call."""
    device = torch.device(device)
    x = torch.randn((n, size, size, channels),
                    generator=_generator(seed, "images", device),
                    device=device)
    return x.cpu().numpy()
