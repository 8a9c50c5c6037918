"""RWKV-6 ("Finch"): the attention-free mixer with data-dependent decay.

The port of `repro/models/rwkv.py`: token-shift lerp mixing, the decay
w_t = exp(-exp(w0 + lora(x))) per channel, the bonus u, the per-head
matrix state S_t = diag(w_t) S_{t-1} + k_t v_t^T, and the squared-ReLU
channel mix.  Head dim d_model / n_heads (160 for the 3B).

Precision is the reference's: the projections sum in f32 (a product
the reference takes in f32 on both operands reads the bf16 operands in
place and sums in f32, the same function: each product of two bf16
values is exact in f32); r, k, v are
rounded to the activations' dtype and taken back to f32 for the
recurrence, g stays f32 through its SiLU, the decay and the state are
f32.  Where the reference runs a chunked `lax.scan` over the sequence,
the port runs a plain loop over T of the same step (a handful of small
kernels a token a layer); no kernel computes this scan in the JAX
package, so none is written here.  On meta the dry run runs one or two
trips of that loop, counted as T (`utils.cost.scan`).

Matmul output precision (`layers.matmul_out_dtype`), site by site: the
time mix's r, k, v (reference ``rwkv.py:124``) and its output
(``:167``) are rounded to the activations' dtype at once, the same
function in both settings; its g (``:124``) is f32 through its SiLU by
default and under ``bf16_flow`` the SiLU of the rounded product, in the
activations' dtype; the channel mix's k (``:184``) is squared in f32 by
default, in the activations' dtype under ``bf16_flow``, and its v
(``:188``) is multiplied by r in f32 by default, rounded first under
``bf16_flow``.  The channel mix's r, the decay's LoRA and the recurrence
stay f32 in both settings, as in the reference.

Caches (per layer): the time mix keeps ``x_prev`` (B, D) in the cache
dtype and ``s`` (B, H, hd, hd) in f32; the channel mix keeps ``x_prev``.
Decode updates them in place and returns the same tensors, so a CUDA
graph over a decode step writes the backend's caches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils.cost import scan

from .layers import P, dense_out, matmul_f32, rms_norm

__all__ = ["rwkv_tm_schema", "rwkv_cm_schema", "rwkv_time_mix",
           "rwkv_channel_mix", "init_rwkv_tm_cache", "init_rwkv_cm_cache"]

W_LORA = 64


def _heads(cfg) -> tuple[int, int]:
    return cfg.n_heads, cfg.d_model // cfg.n_heads


def rwkv_tm_schema(cfg) -> dict:
    d = cfg.d_model
    h, hd = _heads(cfg)

    def proj() -> P:
        return P((d, h, hd), ("fsdp", "heads", "head_dim"), fan_in=d)

    return {
        "mu_r": P((d,), (None,), init="zeros"),
        "mu_k": P((d,), (None,), init="zeros"),
        "mu_v": P((d,), (None,), init="zeros"),
        "mu_g": P((d,), (None,), init="zeros"),
        "mu_w": P((d,), (None,), init="zeros"),
        "w0": P((d,), (None,), init="zeros"),
        "w_lora_a": P((d, W_LORA), ("fsdp", None), fan_in=d),
        "w_lora_b": P((W_LORA, d), (None, "fsdp"), fan_in=W_LORA),
        "wr": proj(), "wk": proj(), "wv": proj(), "wg": proj(),
        "u": P((h, hd), ("heads", "head_dim"), init="zeros"),
        "ln_x": P((h, hd), ("heads", "head_dim"), init="zeros"),
        "wo": P((h, hd, d), ("heads", "head_dim", "fsdp"), fan_in=d),
    }


def rwkv_cm_schema(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": P((d,), (None,), init="zeros"),
        "mu_r": P((d,), (None,), init="zeros"),
        "wr": P((d, d), ("fsdp", None), fan_in=d),
        "wk": P((d, f), ("fsdp", "ff"), fan_in=d),
        "wv": P((f, d), ("ff", "fsdp"), fan_in=f),
    }


def init_rwkv_tm_cache(cfg, batch: int, dtype: torch.dtype,
                       device: torch.device) -> dict:
    h, hd = _heads(cfg)
    return {
        "x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                              device=device),
        "s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                         device=device),
    }


def init_rwkv_cm_cache(cfg, batch: int, dtype: torch.dtype,
                       device: torch.device) -> dict:
    return {"x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                  device=device)}


def _lerp(x: torch.Tensor, x_prev: torch.Tensor, mu: torch.Tensor
          ) -> torch.Tensor:
    return x + (x_prev - x) * mu.to(x.dtype)


def _shifted(x: torch.Tensor, cache: dict | None, decode: bool
             ) -> torch.Tensor:
    """The previous-token stream: the cached ``x_prev`` in decode, else x
    shifted by one with zeros first."""
    if decode:
        return cache["x_prev"][:, None, :].to(x.dtype)
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _tm_step(s: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, w: torch.Tensor, u: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """State S (B, H, K, V); this token's r, k, v, w (B, H, hd)."""
    kv = k[..., :, None] * v[..., None, :]                 # (B, H, K, V)
    y = torch.einsum("bhk,bhkv->bhv", r, s + u[None, :, :, None] * kv)
    return w[..., :, None] * s + kv, y


def rwkv_time_mix(params: dict, x: torch.Tensor, cfg, *,
                  cache: dict | None = None, decode: bool = False,
                  prefill: bool = False) -> tuple[torch.Tensor, dict | None]:
    b, t, d = x.shape
    h, hd = _heads(cfg)
    xs = _shifted(x, cache, decode)
    xr = _lerp(x, xs, params["mu_r"])
    xk = _lerp(x, xs, params["mu_k"])
    xv = _lerp(x, xs, params["mu_v"])
    xg = _lerp(x, xs, params["mu_g"])
    xw = _lerp(x, xs, params["mu_w"])

    r = dense_out(xr, params["wr"]).to(x.dtype)
    k = dense_out(xk, params["wk"]).to(x.dtype)
    v = dense_out(xv, params["wv"]).to(x.dtype)
    g = F.silu(dense_out(xg, params["wg"]))

    # data-dependent decay (the RWKV-6 signature): per channel, in (0, 1)
    lora = torch.tanh(matmul_f32(xw, params["w_lora_a"]))
    lora = lora @ params["w_lora_b"].float()
    w_dec = torch.exp(-torch.exp(params["w0"].float() + lora))
    w_dec = w_dec.reshape(b, t, h, hd)

    r32, k32, v32 = r.float(), k.float(), v.float()
    u = params["u"].float()

    if decode:
        s, y = _tm_step(cache["s"], r32[:, 0], k32[:, 0], v32[:, 0],
                        w_dec[:, 0], u)
        cache["s"].copy_(s)
        cache["x_prev"].copy_(x[:, -1, :])
        y = y[:, None]
        new_cache = cache
    else:
        s = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                        device=x.device)
        s, ys = scan(lambda s, i: _tm_step(s, r32[:, i], k32[:, i],
                                           v32[:, i], w_dec[:, i], u),
                     s, t, x)
        y = torch.stack(ys, dim=1)                           # (B, T, H, hd)
        new_cache = None
        if prefill:
            new_cache = {"x_prev": x[:, -1, :].to(cfg.cache_dtype), "s": s}

    y = rms_norm(y, params["ln_x"])  # per-head group norm
    y = (y * g).to(x.dtype)
    out = dense_out(y.reshape(b, t, h * hd),
                    params["wo"].reshape(h * hd, d)).to(x.dtype)
    return out, new_cache


def rwkv_channel_mix(params: dict, x: torch.Tensor, cfg, *,
                     cache: dict | None = None, decode: bool = False,
                     prefill: bool = False
                     ) -> tuple[torch.Tensor, dict | None]:
    xs = _shifted(x, cache, decode)
    xk = _lerp(x, xs, params["mu_k"])
    xr = _lerp(x, xs, params["mu_r"])
    r = torch.sigmoid(matmul_f32(xr, params["wr"]))
    k = dense_out(xk, params["wk"])
    hidden = torch.square(torch.relu(k))                     # squared ReLU
    v = dense_out(hidden.to(x.dtype), params["wv"])
    out = (r * v).to(x.dtype)
    new_cache = None
    if decode:
        cache["x_prev"].copy_(x[:, -1, :])
        new_cache = cache
    elif prefill:
        new_cache = {"x_prev": x[:, -1, :].to(cfg.cache_dtype)}
    return out, new_cache
