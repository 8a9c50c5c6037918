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
f32.  The scan over the sequence is the reference's chunked remat scan
(`layers.chunked_remat_scan`: a loop over T of the same step, a handful
of small kernels a token a layer, under a gradient recomputed a chunk
of ``cfg.scan_chunk`` steps at a time); no kernel computes this scan in
the JAX package, so none is written here.  On meta the dry run runs a
few trips of each loop, counted as the loop's (`utils.cost.scan`).

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

Under a mesh (`parallel.sharding.use_mesh`) the time mix is
head-parallel and the channel mix F-parallel, the reference's layout:
each rank holds its batch rows, its heads (``heads`` on the model dim)
of r, k, v, g, u, the group norm, the state and ``wo``, and its slice of
F of the channel mix; the output products sum over the model dim.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import logical
from repro_torch.utils.cost import scan

from .layers import P, chunked_remat_scan, dense_out, matmul_f32, rms_norm

__all__ = ["rwkv_tm_schema", "rwkv_cm_schema", "rwkv_time_mix",
           "rwkv_channel_mix", "init_rwkv_tm_cache", "init_rwkv_cm_cache",
           "RWKV_TM_CACHE_AXES", "RWKV_CM_CACHE_AXES"]

RWKV_TM_CACHE_AXES = {
    "x_prev": ("batch", None),
    "s": ("batch", "heads", "head_dim", None),
}
RWKV_CM_CACHE_AXES = {"x_prev": ("batch", None)}

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


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _local_params(params: dict, schema: dict, drop: str) -> dict:
    """Each DTensor param's shard under its schema axes with ``drop``
    (the fsdp dim) gathered."""
    return {k: shd.local(v, tuple(None if a == drop else a
                                  for a in schema[k].axes))
            for k, v in params.items()}


def _mesh_mix(fn, params: dict, schema: dict, x: torch.Tensor, cache,
              axes: dict, entry, decode: bool, prefill: bool, **kw):
    """Run ``fn`` (a mixer on plain tensors) on this rank's batch rows
    and shards, its output summed over ``entry`` (the model dim's
    share), and lay the outputs back out as DTensors."""
    b, t, d = x.shape
    lp = _local_params(params, schema, "fsdp")
    xl = shd.local(x, ("batch", None, None))
    cl = None if cache is None else {k: v.to_local()
                                     for k, v in cache.items()}
    out, nc = fn(lp, xl, cache=cl, decode=decode, prefill=prefill,
                 reduce=lambda y: shd.all_reduce(y, entry), **kw)
    out = shd.from_local(out, ("batch", None, None), (b, t, d))
    if decode:
        nc = cache
    elif nc is not None:
        nc = {k: shd.from_local(v, axes[k], (b, *_global(v, k, kw)))
              for k, v in nc.items()}
    return logical(out, ("batch", "seq", "embed")), nc


def _global(v: torch.Tensor, key: str, kw: dict) -> tuple:
    """A local cache leaf's global shape past the batch dim."""
    if key == "s":
        return (kw["n_heads"], *v.shape[2:])
    return tuple(v.shape[1:])


def rwkv_time_mix(params: dict, x: torch.Tensor, cfg, *,
                  cache: dict | None = None, decode: bool = False,
                  prefill: bool = False) -> tuple[torch.Tensor, dict | None]:
    h, _ = _heads(cfg)
    if shd.current() is None:
        return _time_mix(params, x, cfg, cache=cache, decode=decode,
                         prefill=prefill)
    ctx = shd.current()
    entry = shd.spec_for(("heads",), mesh=ctx.mesh, rules=ctx.rules,
                         shape=(h,))[0]
    return _mesh_mix(
        lambda p, xl, **k: _time_mix(p, xl, cfg, **k), params,
        rwkv_tm_schema(cfg), x, cache, RWKV_TM_CACHE_AXES, entry, decode,
        prefill, h0=shd.axis_index(entry) * (h // shd.axis_size(entry)),
        n_heads=h)


def _time_mix(params: dict, x: torch.Tensor, cfg, *, cache: dict | None,
              decode: bool, prefill: bool, reduce=_same, h0: int = 0,
              n_heads: int | None = None
              ) -> tuple[torch.Tensor, dict | None]:
    """The time mix on plain tensors, over all heads or this rank's
    (``u``'s rows, from head ``h0``); ``reduce`` sums the output
    product's share over the model dim."""
    b, t, d = x.shape
    h_all, hd = _heads(cfg)
    h = params["u"].shape[0]
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
    w_dec = w_dec.reshape(b, t, h_all, hd)
    if h != h_all:
        w_dec = w_dec[:, :, h0:h0 + h]

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
        s, y = chunked_remat_scan(
            lambda s, xi, sh: _tm_step(s, *xi, *sh), s, t,
            (r32, k32, v32, w_dec), (u,), chunk=cfg.scan_chunk,
            loop=scan)                                        # (B, T, H, hd)
        new_cache = None
        if prefill:
            new_cache = {"x_prev": x[:, -1, :].to(cfg.cache_dtype), "s": s}

    y = rms_norm(y, params["ln_x"])  # per-head group norm
    y = (y * g).to(x.dtype)
    out = reduce(dense_out(y.reshape(b, t, h * hd),
                           params["wo"].reshape(h * hd, d))).to(x.dtype)
    return out, new_cache


def rwkv_channel_mix(params: dict, x: torch.Tensor, cfg, *,
                     cache: dict | None = None, decode: bool = False,
                     prefill: bool = False
                     ) -> tuple[torch.Tensor, dict | None]:
    if shd.current() is None:
        return _channel_mix(params, x, cfg, cache=cache, decode=decode,
                            prefill=prefill)
    ctx = shd.current()
    entry = shd.spec_for(("ff",), mesh=ctx.mesh, rules=ctx.rules,
                         shape=(cfg.d_ff,))[0]
    return _mesh_mix(lambda p, xl, **k: _channel_mix(p, xl, cfg, **k),
                     params, rwkv_cm_schema(cfg), x, cache,
                     RWKV_CM_CACHE_AXES, entry, decode, prefill)


def _channel_mix(params: dict, x: torch.Tensor, cfg, *, cache: dict | None,
                 decode: bool, prefill: bool, reduce=_same
                 ) -> tuple[torch.Tensor, dict | None]:
    """The channel mix on plain tensors, over all of F or a slice of it;
    ``reduce`` sums the down product's share over the model dim."""
    xs = _shifted(x, cache, decode)
    xk = _lerp(x, xs, params["mu_k"])
    xr = _lerp(x, xs, params["mu_r"])
    r = torch.sigmoid(matmul_f32(xr, params["wr"]))
    k = dense_out(xk, params["wk"])
    hidden = torch.square(torch.relu(k))                     # squared ReLU
    v = reduce(dense_out(hidden.to(x.dtype), params["wv"]))
    out = (r * v).to(x.dtype)
    new_cache = None
    if decode:
        cache["x_prev"].copy_(x[:, -1, :])
        new_cache = cache
    elif prefill:
        new_cache = {"x_prev": x[:, -1, :].to(cfg.cache_dtype)}
    return out, new_cache
