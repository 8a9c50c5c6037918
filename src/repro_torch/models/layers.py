"""Param schema leaves and deterministic initialization.

A model's schema is a nested dict whose leaves are `P` entries (shape,
logical axes, init law); `init_params` turns it into a nested dict of
tensors.  The laws are the reference's `_leaf_init`: ``normal`` draws
N(0, 1) scaled by fan_in^-1/2, ``zeros`` / ``ones`` are constant.  Each
leaf draws from its own `torch.Generator`, seeded from the run's seed and a
CRC of the leaf's path, on the CPU — so the weights do not depend on the
device and no leaf's draw depends on another's.  (The numbers differ from
the JAX package's; tests that need both sides equal hand the same numpy
weights to both.)
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import torch

from repro_torch.core.device import resolve_device

__all__ = ["P", "init_params"]


@dataclasses.dataclass(frozen=True)
class P:
    """Schema leaf: one parameter array."""

    shape: tuple
    axes: tuple  # logical axis name (or None) per dim
    init: str = "normal"  # 'normal' | 'zeros' | 'ones'
    fan_in: int | None = None  # scaled normal: std = 1/sqrt(fan_in)
    dtype: Any = None  # None -> the init_params default

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _leaf_init(p: P, seed: int, path: str,
               default_dtype: torch.dtype) -> torch.Tensor:
    dtype = p.dtype or default_dtype
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype)
    if p.init != "normal":
        raise NotImplementedError(f"init law {p.init!r} belongs to the LM "
                                  f"arm, ported in a later slice")
    # the CPU generator keeps 32 bits of its seed: hash seed and path into 32
    gen = torch.Generator().manual_seed(zlib.crc32(f"{seed}:{path}".encode()))
    fan_in = p.fan_in or (p.shape[0] if p.shape else 1)
    std = fan_in ** -0.5
    return (std * torch.randn(p.shape, generator=gen,
                              dtype=torch.float32)).to(dtype)


def init_params(schema: dict, seed: int = 0, *,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> dict:
    """Deterministic init of a schema on ``device`` (CUDA by default)."""
    dev = resolve_device(device)

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, P):
            return _leaf_init(node, seed, path, dtype).to(dev)
        return {k: walk(v, f"{path}[{k!r}]") for k, v in node.items()}

    return walk(schema, "")
