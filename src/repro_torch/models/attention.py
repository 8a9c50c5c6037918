"""GQA attention: flash prefill through the CUDA kernel, KV-cache decode.

The port of `repro/models/attention.py`.  Layouts are the reference's:
activations (B, T, H, hd), caches (B, capacity, KV, hd).

Prefill (and any full-sequence forward) transposes q and the repeated K/V
to (B*H, T, hd), as the reference's `_flash_pallas` does, and calls
`kernels.flash.flash_fwd_kernel`: on a CUDA tensor that launches the
hand-written kernel, on a CPU tensor it runs the plain version.  This
holds for either ``cfg.attn_impl``: the port has no mesh, and in the
reference ``"xla"`` only selects the GSPMD-partitionable form of the same
function, so no CUDA path runs the plain version.  The reference's
`logical` sharding constraints have no counterpart here.

Decode is plain torch, as in the reference (no Pallas kernel there): one
query against the circular cache, grouped products, absolute positions
per slot, window mask, f32 softmax.  The position is a 0-d int64 tensor
on the device, so one CUDA graph serves every step; the port writes the
new K/V row into the cache in place (``index_copy_`` at ``pos % cap``)
and returns the same tensors.  The scores read a bf16 cache as it is and
sum in f32 (`_decode_scores`); the values product promotes the cache to
f32, as the reference's does (its ``p`` is f32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash import NEG_INF, flash_fwd_kernel
from .layers import P, rms_norm, rope

__all__ = ["attn_schema", "attention_apply", "decode_position",
           "flash_attention", "init_kv_cache", "repeat_kv"]


def attn_schema(cfg) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": P((d, h, hd), ("fsdp", "heads", "head_dim"), fan_in=d),
        "wk": P((d, kv, hd), ("fsdp", "kv_heads", "head_dim"), fan_in=d),
        "wv": P((d, kv, hd), ("fsdp", "kv_heads", "head_dim"), fan_in=d),
        "wo": P((h, hd, d), ("heads", "head_dim", "fsdp"), fan_in=h * hd),
    }
    if cfg.qkv_bias:
        s["bq"] = P((h, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = P((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = P((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = P((hd,), (None,), init="zeros")
        s["k_norm"] = P((hd,), (None,), init="zeros")
    return s


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, H, hd), each KV head repeated H/KV times."""
    b, t, kvh, hd = k.shape
    if kvh == n_heads:
        return k
    g = n_heads // kvh
    return k[:, :, :, None, :].expand(b, t, kvh, g, hd).reshape(
        b, t, n_heads, hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over (B, T, H, hd): q, k, v with KV already
    repeated to H (see `repeat_kv`).  ``q_offset`` places query positions
    at q_offset + [0, Tq) against key positions [0, Tk).

    Transposes to (B*H, T, hd) and calls `flash_fwd_kernel` (the CUDA
    kernel on the card, its plain version on the CPU).
    """
    b, t, h, hd = q.shape
    tk = k.shape[1]

    def to_bh(a: torch.Tensor, n: int) -> torch.Tensor:
        return a.transpose(1, 2).reshape(b * h, n, hd).contiguous()

    out = flash_fwd_kernel(to_bh(q, t), to_bh(k, tk), to_bh(v, tk),
                           causal=causal, window=window, q_offset=q_offset)
    return out.reshape(b, h, t, hd).transpose(1, 2)


def decode_position(pos: torch.Tensor | int, device: torch.device
                    ) -> torch.Tensor:
    """A decode position as a 0-d int64 tensor on ``device``: a tensor as
    it is, an int filled in on the device (no copy from the host)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), pos, dtype=torch.int64, device=device)


def init_kv_cache(cfg, batch: int, capacity: int, dtype: torch.dtype,
                  device: torch.device) -> dict:
    """One layer's cache arrays; the stack wrapper adds the group dim."""
    shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _persist_cache(k: torch.Tensor, v: torch.Tensor, t: int, cap: int,
                   cfg) -> dict:
    """Prefill K/V persistence: the first ``t`` slots hold positions
    [0, t) when the cache holds them all; else the last ``cap`` positions,
    circularly addressed (position p in slot p % cap)."""
    if cap >= t:
        pad = (0, 0, 0, 0, 0, cap - t)
        kc, vc = F.pad(k, pad), F.pad(v, pad)
    else:
        src = t - 1 - (t - 1 - torch.arange(cap, device=k.device)) % cap
        kc, vc = k[:, src], v[:, src]
    return {"k": kc.to(cfg.cache_dtype), "v": vc.to(cfg.cache_dtype)}


def _project_qkv(params: dict, x: torch.Tensor, cfg
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    def proj(w: torch.Tensor) -> torch.Tensor:
        return torch.einsum("btd,dhk->bthk", x, w).to(x.dtype)

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    return q, k, v


def _decode_scores(qg: torch.Tensor, k_cache: torch.Tensor
                   ) -> torch.Tensor:
    """Queries (B, KV, G, hd) against the cache (B, cap, KV, hd) -> (B, KV,
    G, cap) f32 dot products, summed in f32: the reference's
    ``preferred_element_type=f32``.  On the card a bf16 or f16 cache is
    read in place: one ``bmm`` a batch row over a strided view of the
    cache, f32 out (``aten::bmm.dtype``), so no copy of it is made.
    Elsewhere both operands are taken to f32, the same function (each
    product of two bf16 values is exact in f32)."""
    if k_cache.device.type != "cuda" or k_cache.dtype == torch.float32 \
            or qg.dtype != k_cache.dtype:
        return torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    kt = k_cache.permute(0, 2, 3, 1)  # (B, KV, hd, cap): a view
    return torch.stack([torch.bmm(qg[i], kt[i], out_dtype=torch.float32)
                        for i in range(qg.shape[0])])


def _decode_values(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """Softmax weights (B, KV, G, cap) f32 against the cache (B, cap, KV,
    hd) -> (B, KV, G, hd) f32.  The cache is promoted to f32, as the
    reference's product promotes it (its ``p`` is f32): one f32 copy of
    a bf16 cache a layer, made head-major, so one batched product takes
    every (batch, head) pair."""
    b, cap, kvh, hd = v_cache.shape
    vf = torch.empty((b, kvh, cap, hd), dtype=torch.float32,
                     device=v_cache.device)
    vf.copy_(v_cache.permute(0, 2, 1, 3))
    return torch.matmul(p, vf)


def _out_proj(out: torch.Tensor, params: dict, x: torch.Tensor
              ) -> torch.Tensor:
    return torch.einsum("bthk,hkd->btd", out.to(x.dtype),
                        params["wo"]).to(x.dtype)


def attention_apply(params: dict, x: torch.Tensor, cfg, *,
                    window: int | None = None, cache: dict | None = None,
                    pos: torch.Tensor | int | None = None,
                    decode: bool = False,
                    cache_capacity: int | None = None
                    ) -> tuple[torch.Tensor, dict | None]:
    """Returns (out, new_cache); new_cache is None without a cache.

    Prefill / full sequence: flash attention over positions [0, T); if
    ``cache_capacity`` is given the projected K/V are persisted.  Decode:
    x is (B, 1, D) at position ``pos`` (a 0-d integer tensor on x's
    device, or an int); writes slot pos % capacity of the cache in place
    and reads it.  The absolute position of slot i under write head
    ``pos`` is pos - ((pos - i) % cap), which is i when cap > pos (a plain
    cache); slots of negative position are masked.
    """
    b, t, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    hd = cfg.head_dim

    if decode:
        if cache is None or pos is None:
            raise ValueError("decode needs the cache and the position")
        pos = decode_position(pos, x.device)
        q = rope(q, pos.reshape(1), theta=cfg.rope_theta)
        k = rope(k, pos.reshape(1), theta=cfg.rope_theta)
        k_cache, v_cache = cache["k"], cache["v"]
        cap = k_cache.shape[1]
        slot = (pos % cap).reshape(1)
        k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
        v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
        kvh = cfg.n_kv_heads
        g = cfg.n_heads // kvh
        qg = q.reshape(b, kvh, g, hd)
        scores = _decode_scores(qg, k_cache) * (hd ** -0.5)
        kpos = pos - (pos - torch.arange(cap, device=x.device)) % cap
        valid = kpos >= 0
        if window is not None:
            valid &= pos - kpos < window
        scores = torch.where(valid, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out = _decode_values(p, v_cache).to(x.dtype)
        out = out.reshape(b, 1, cfg.n_heads, hd)
        return _out_proj(out, params, x), {"k": k_cache, "v": v_cache}

    positions = torch.arange(t, device=x.device)
    q = rope(q, positions, theta=cfg.rope_theta)
    k = rope(k, positions, theta=cfg.rope_theta)
    out = flash_attention(q, repeat_kv(k, cfg.n_heads),
                          repeat_kv(v, cfg.n_heads), causal=cfg.causal,
                          window=window)
    new_cache = None
    if cache_capacity is not None:
        new_cache = _persist_cache(k, v, t, cache_capacity, cfg)
    return _out_proj(out, params, x), new_cache
