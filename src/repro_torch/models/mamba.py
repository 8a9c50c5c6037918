"""Mamba (S6 selective SSM): the Jamba hybrid's recurrent mixer.

The port of `repro/models/mamba.py`.  d_inner = 2 * d_model, state size
16, a causal depthwise conv of width 4, dt rank ceil(d_model / 16).  The
in/out projections sum in f32 and round to the activations' dtype; the
conv output, dt, B, C, the state and the scan are f32, as in the
reference.  The scan over the sequence is the reference's chunked remat
scan (`layers.chunked_remat_scan`: a loop over T of the same step, under
a gradient recomputed a chunk of ``cfg.scan_chunk`` steps at a time);
no kernel computes this scan in the JAX package, so none is written
here.  On meta the dry run runs a few trips of each loop, counted as
the loop's (`utils.cost.scan`).

Matmul output precision (`layers.matmul_out_dtype`; reference
``mamba.py:97`` and ``:147``): both projections are rounded to the
activations' dtype at once, the same function in both settings; under
``bf16_flow`` they are taken in that dtype (no f32 copy).

Caches (per layer): ``conv`` (B, 3, d_inner), the last three conv
inputs, in the cache dtype, and ``ssm`` (B, d_inner, 16) in f32.  Decode
updates both in place and returns the same tensors.

Under a mesh (`parallel.sharding.use_mesh`) the mixer is
channel-parallel, as the reference lays it out: each rank holds its
batch rows and its slice of d_inner (``ff`` on the model dim) of every
channel-wise weight and of both caches, and the two products that sum
over d_inner (``x_proj``, ``out_proj``) are summed over the model dim
(`_mamba_mesh`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import logical
from repro_torch.utils.cost import scan

from .layers import P, chunked_remat_scan, dense_out, matmul_f32

__all__ = ["mamba_schema", "mamba_apply", "init_mamba_cache",
           "MAMBA_CACHE_AXES"]

MAMBA_CACHE_AXES = {
    "conv": ("batch", None, "ff"),
    "ssm": ("batch", "ff", None),
}

D_STATE = 16
D_CONV = 4


def _dims(cfg) -> tuple[int, int]:
    d_in = 2 * cfg.d_model
    dt_rank = -(-cfg.d_model // 16)
    return d_in, dt_rank


def mamba_schema(cfg) -> dict:
    d = cfg.d_model
    d_in, dt_rank = _dims(cfg)
    return {
        "in_proj": P((2, d, d_in), (None, "fsdp", "ff"), fan_in=d),
        "conv_w": P((D_CONV, d_in), (None, "ff"), fan_in=D_CONV),
        "conv_b": P((d_in,), ("ff",), init="zeros"),
        "x_proj": P((d_in, dt_rank + 2 * D_STATE), ("ff", None), fan_in=d_in),
        "dt_proj": P((dt_rank, d_in), (None, "ff"), fan_in=dt_rank),
        "dt_bias": P((d_in,), ("ff",), init="zeros"),
        "a_log": P((d_in, D_STATE), ("ff", None), init="a_log"),
        "d_skip": P((d_in,), ("ff",), init="ones"),
        "out_proj": P((d_in, d), ("ff", "fsdp"), fan_in=d_in),
    }


def init_mamba_cache(cfg, batch: int, dtype: torch.dtype,
                     device: torch.device) -> dict:
    d_in, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, D_CONV - 1, d_in), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_in, D_STATE), dtype=torch.float32,
                           device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference's logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _ssm_inputs(params: dict, xc: torch.Tensor, cfg, reduce=_same
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xc (B, T, d_in) post-conv activations -> (dt, B_ssm, C_ssm), f32;
    ``reduce`` completes the sum over d_inner of a channel slice."""
    _, dt_rank = _dims(cfg)
    proj = reduce(matmul_f32(xc, params["x_proj"]))
    dt_raw = proj[..., :dt_rank]
    b_ssm = proj[..., dt_rank:dt_rank + D_STATE]
    c_ssm = proj[..., dt_rank + D_STATE:]
    dt = _softplus(dt_raw @ params["dt_proj"].float()
                   + params["dt_bias"].float())
    return dt, b_ssm, c_ssm


def _scan_step(a_neg: torch.Tensor, h: torch.Tensor, xc: torch.Tensor,
               dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(dt A) h_{t-1} + dt B x_t ; y_t = <h_t, C_t> per channel.
    xc, dt (B, d_in); b, c (B, N); h (B, d_in, N)."""
    da = torch.exp(dt[..., None] * a_neg[None])             # (B, d_in, N)
    dbx = (dt * xc.float())[..., None] * b[:, None, :]
    h = da * h + dbx
    y = torch.einsum("bin,bn->bi", h, c)                    # (B, d_in)
    return h, y


def mamba_apply(params: dict, x: torch.Tensor, cfg, *,
                cache: dict | None = None, decode: bool = False,
                prefill: bool = False) -> tuple[torch.Tensor, dict | None]:
    """x (B, T, D) -> (out (B, T, D), new_cache)."""
    if shd.current() is not None:
        return _mamba_mesh(params, x, cfg, cache=cache, decode=decode,
                           prefill=prefill)
    return _mamba(params, x, cfg, cache=cache, decode=decode,
                  prefill=prefill)


def _mamba(params: dict, x: torch.Tensor, cfg, *, cache: dict | None,
           decode: bool, prefill: bool, reduce=_same
           ) -> tuple[torch.Tensor, dict | None]:
    """The mixer on plain tensors, over all of d_inner or a slice of it
    (its width from ``a_log``); ``reduce`` sums a slice's share of the
    products over d_inner."""
    b, t, _ = x.shape
    d_in = params["a_log"].shape[0]
    x_in = dense_out(x, params["in_proj"][0]).to(x.dtype)
    z = dense_out(x, params["in_proj"][1]).to(x.dtype)
    a_neg = -torch.exp(params["a_log"].float())
    conv_b = params["conv_b"].float()

    if decode:
        if cache is None:
            raise ValueError("decode needs the cache")
        # causal depthwise conv over (cached tail ++ current token)
        window = torch.cat([cache["conv"].to(x_in.dtype), x_in], dim=1)
        xc = torch.einsum("bki,ki->bi", window.float(),
                          params["conv_w"].float())
        xc = F.silu(xc + conv_b)[:, None, :].to(x.dtype)      # (B, 1, d_in)
        dt, b_ssm, c_ssm = _ssm_inputs(params, xc, cfg, reduce)
        h, y = _scan_step(a_neg, cache["ssm"], xc[:, 0], dt[:, 0],
                          b_ssm[:, 0], c_ssm[:, 0])
        cache["ssm"].copy_(h)
        cache["conv"].copy_(window[:, 1:])
        y = y[:, None, :]
        new_cache = cache
    else:
        weight = params["conv_w"].to(x.dtype).t()[:, None, :]  # (d_in, 1, K)
        xc = F.conv1d(F.pad(x_in.transpose(1, 2), (D_CONV - 1, 0)), weight,
                      groups=d_in).transpose(1, 2)
        xc = F.silu(xc.float() + conv_b).to(x.dtype)
        dt, b_ssm, c_ssm = _ssm_inputs(params, xc, cfg, reduce)
        h = torch.zeros((b, d_in, D_STATE), dtype=torch.float32,
                        device=x.device)
        h, y = chunked_remat_scan(
            lambda h, xi, sh: _scan_step(*sh, h, *xi), h, t,
            (xc, dt, b_ssm, c_ssm), (a_neg,), chunk=cfg.scan_chunk,
            loop=scan)                                        # (B, T, d_in)
        new_cache = None
        if prefill:  # persist the conv tail and the final ssm state
            tail = x_in[:, -(D_CONV - 1):, :]
            new_cache = {"conv": tail.to(cfg.cache_dtype), "ssm": h}

    y = y.float() + params["d_skip"].float() * x_in.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = reduce(dense_out(y, params["out_proj"])).to(x.dtype)
    return out, new_cache


def _mamba_mesh(params: dict, x: torch.Tensor, cfg, *, cache: dict | None,
                decode: bool, prefill: bool
                ) -> tuple[torch.Tensor, dict | None]:
    """The mixer over DTensors: each rank runs `_mamba` on its batch rows
    and its d_inner slice (the schema's ``ff``; ``fsdp`` dims gathered),
    the two d_inner sums completed over the model dim."""
    ctx = shd.current()
    b, t, d = x.shape
    d_in, _ = _dims(cfg)
    schema = mamba_schema(cfg)
    f_entry = shd.spec_for(("ff",), mesh=ctx.mesh, rules=ctx.rules,
                           shape=(d_in,))[0]
    lp = {k: shd.local(v, tuple(None if a == "fsdp" else a
                                for a in schema[k].axes))
          for k, v in params.items()}
    xl = shd.local(x, ("batch", None, None))
    cl = None if cache is None else {k: v.to_local()
                                     for k, v in cache.items()}
    out, nc = _mamba(lp, xl, cfg, cache=cl, decode=decode, prefill=prefill,
                     reduce=lambda y: shd.all_reduce(y, f_entry))
    out = shd.from_local(out, ("batch", None, None), (b, t, d))
    if decode:
        nc = cache
    elif nc is not None:
        shapes = {"conv": (b, D_CONV - 1, d_in), "ssm": (b, d_in, D_STATE)}
        nc = {k: shd.from_local(v, MAMBA_CACHE_AXES[k], shapes[k])
              for k, v in nc.items()}
    return logical(out, ("batch", "seq", "embed")), nc
