"""Param schema leaves, deterministic initialization, and the LM's layers.

A model's schema is a nested dict (or list) whose leaves are `P` entries
(shape, logical axes, init law); `init_params` turns it into the same
nesting of tensors.  The laws are the reference's `_leaf_init`: ``normal``
draws N(0, 1) scaled by fan_in^-1/2, ``embed`` by shape[-1]^-1/2,
``zeros`` / ``ones`` are constant.  Each leaf draws from its own
`torch.Generator`, seeded from the run's seed and a CRC of the leaf's
path, on the CPU — so the weights do not depend on the device and no
leaf's draw depends on another's.  A leaf with a leading ``stack`` axis
(`stack`) draws each slice of that axis from its own generator (seed,
path, index) and moves it to the device before the next is drawn, so host
memory holds one layer's slice at a time, not the whole stack (Qwen1.5-4B's
stacked ``wi`` is 1.4 G values).  (The numbers differ from the JAX
package's; tests that need both sides equal hand the same numpy weights to
both.)

The layers are the reference's `rms_norm`, `rope`, `dense`, `mlp_schema`
and `mlp_apply`, with its precision: norms, rotary angles and activations
in f32, matmuls accumulated in f32 and returned in the input's dtype.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device

__all__ = ["P", "init_params", "stack", "rms_norm", "dense", "rope",
           "mlp_schema", "mlp_apply"]


@dataclasses.dataclass(frozen=True)
class P:
    """Schema leaf: one parameter array."""

    shape: tuple
    axes: tuple  # logical axis name (or None) per dim
    init: str = "normal"  # 'normal' | 'embed' | 'zeros' | 'ones'
    fan_in: int | None = None  # scaled normal: std = 1/sqrt(fan_in)
    dtype: Any = None  # None -> the init_params default

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _draw(p: P, shape: tuple, key: str, dtype: torch.dtype) -> torch.Tensor:
    """One tensor of law ``p.init`` and ``shape``, on the CPU."""
    if p.init == "zeros":
        return torch.zeros(shape, dtype=dtype)
    if p.init == "ones":
        return torch.ones(shape, dtype=dtype)
    if p.init == "embed":
        std = p.shape[-1] ** -0.5
    elif p.init == "normal":
        fan_in = p.fan_in or (p.shape[0] if p.shape else 1)
        std = fan_in ** -0.5
    else:
        raise NotImplementedError(f"init law {p.init!r} belongs to a later "
                                  f"slice of the LM arm")
    # the CPU generator keeps 32 bits of its seed: hash seed and path into 32
    gen = torch.Generator().manual_seed(zlib.crc32(key.encode()))
    return (std * torch.randn(shape, generator=gen,
                              dtype=torch.float32)).to(dtype)


def _leaf_init(p: P, seed: int, path: str, default_dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    dtype = p.dtype or default_dtype
    key = f"{seed}:{path}"
    if not p.axes or p.axes[0] != "stack":
        return _draw(p, p.shape, key, dtype).to(device)
    out = torch.empty(p.shape, dtype=dtype, device=device)
    for i in range(p.shape[0]):
        out[i] = _draw(p, p.shape[1:], f"{key}:{i}", dtype)
    return out


def init_params(schema: Any, seed: int = 0, *,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> Any:
    """Deterministic init of a schema on ``device`` (CUDA by default)."""
    dev = resolve_device(device)

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, P):
            return _leaf_init(node, seed, path, dtype, dev)
        if isinstance(node, list):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
        return {k: walk(v, f"{path}[{k!r}]") for k, v in node.items()}

    return walk(schema, "")


def stack(schema: Any, n: int) -> Any:
    """Prepend a layer-group dim of size n (axis ``stack``) to every leaf."""
    if isinstance(schema, P):
        return P((n, *schema.shape), ("stack", *schema.axes), schema.init,
                 schema.fan_in, schema.dtype)
    return {k: stack(v, n) for k, v in schema.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, ...out), accumulated in f32, in x.dtype.

    A bf16 product accumulates in f32 and rounds its output once, as the
    reference's ``preferred_element_type=f32`` then ``astype`` does.
    """
    return torch.tensordot(x, w, dims=([x.ndim - 1], [0])).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding. x (B, T, H, hd), positions (B, T) or (T,)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(theta, exps)  # f32: the scalar base is cast to f32
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq  # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- gated / plain MLP -------------------------------------------------------

_GATED = {"swiglu", "geglu"}


def mlp_schema(d_model: int, d_ff: int, activation: str) -> dict:
    if activation in _GATED:
        wi = P((2, d_model, d_ff), (None, "fsdp", "ff"), fan_in=d_model)
    else:
        wi = P((d_model, d_ff), ("fsdp", "ff"), fan_in=d_model)
    return {
        "wi": wi,
        "wo": P((d_ff, d_model), ("ff", "fsdp"), fan_in=d_ff),
    }


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu2":  # nemotron squared-ReLU
        r = torch.relu(h)
        return r * r
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")
    if kind == "relu":
        return torch.relu(h)
    raise ValueError(kind)


def mlp_apply(params: dict, x: torch.Tensor, *,
              activation: str) -> torch.Tensor:
    if activation in _GATED:
        gate = dense(x, params["wi"][0])
        up = dense(x, params["wi"][1])
        act = F.silu if activation == "swiglu" else (
            lambda g: F.gelu(g, approximate="tanh"))
        h = act(gate.float()).to(x.dtype) * up
    else:
        h = dense(x, params["wi"])
        h = _act(h.float(), activation).to(x.dtype)
    return dense(h, params["wo"])
