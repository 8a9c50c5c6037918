"""GQA attention: flash prefill through the CUDA kernel, KV-cache decode.

The port of `repro/models/attention.py`.  Layouts are the reference's:
activations (B, T, H, hd), caches (B, capacity, KV, hd).

Prefill (and any full-sequence forward) transposes q and the repeated K/V
to (B*H, T, hd), as the reference's `_flash_pallas` does, and calls
`kernels.flash.flash_fwd_kernel`: on a CUDA tensor that launches the
hand-written kernel, on a CPU tensor it runs the plain version.  This
holds for either ``cfg.attn_impl`` and under a mesh too: in the
reference ``"xla"`` only selects the GSPMD-partitionable form of the same
function, which the port's mesh path feeds the kernel shard by shard
(`_prefill_mesh`), so no CUDA path runs the plain version.  A training forward on
the card takes the kernel under autograd (`flash_fwd_trainable`), whose
backward is plain torch: the reference trains through its jnp flash and
lets XLA derive the backward.

Under a mesh (`parallel.sharding.use_mesh`; activations and weights
DTensors) the reference's `logical` constraints are redistributes, and
the products run on each rank's shards: the projections on its heads,
the flash kernel on its heads (``heads``) or on its slice of the
sequence at ``q_offset`` against the whole K/V (``sp``), the output
product summed over the heads' mesh dims; decode writes the new K/V row
on the rank that owns its slot of the sequence-sharded cache and
combines the softmax over the model dim (`_prefill_mesh`,
`_decode_mesh`).  A training forward under a mesh takes the same path
(`_prefill_mesh`): on the card the kernel runs under autograd on each
rank's shard, at the shard's ``q_offset`` for ``sp``, and its backward
(`kernels.flash.flash_bwd_plain`) takes the same offset.

Decode is plain torch, as in the reference (no Pallas kernel there): one
query against the circular cache, grouped products, absolute positions
per slot, window mask, f32 softmax.  The position is a 0-d int64 tensor
on the device, so one CUDA graph serves every step; the port writes the
new K/V row into the cache in place (``index_copy_`` at ``pos % cap``)
and returns the same tensors.  The scores read a bf16 cache as it is and
sum in f32 (`_decode_scores`); the values product promotes the cache to
f32, as the reference's does (its ``p`` is f32).

Matmul output precision (`layers.matmul_out_dtype`), site by site: the
q, k, v projections (reference ``attention.py:192``) and the output
projection (``:306``, ``:339``) are rounded to the activations' dtype
at once, the same function in both settings: the port takes them in
that dtype in both.  ``:122`` rounds the jnp flash's p to v's dtype under
``bf16_flow``; the port runs its flash kernel in both settings, as the
reference's Pallas path does (its bf16 body rounds p to bf16 for the PV
product, its f32 body keeps it f32).  The decode scores and values are
f32 in both, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.device import card_path
from repro_torch.kernels.flash import (NEG_INF, flash_fwd_kernel,
                                      flash_fwd_trainable)
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import logical
from .layers import P, rms_norm, rope

__all__ = ["attn_schema", "attention_apply", "decode_position",
           "flash_attention", "init_kv_cache", "repeat_kv", "CACHE_AXES"]

CACHE_AXES = {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
              "v": ("batch", "kv_seq", "kv_heads", "head_dim")}


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
    kernel on the card, its plain version on the CPU).  On the card, when
    grad mode is on and an input requires grad (a training forward, or
    its recompute under remat), the kernel runs under autograd
    (`flash_fwd_trainable`); on the CPU the plain version runs under
    autograd itself.  A meta tensor takes the card's path
    (`core.device.card_path`).
    """
    b, t, h, hd = q.shape
    tk = k.shape[1]

    def to_bh(a: torch.Tensor, n: int) -> torch.Tensor:
        return a.transpose(1, 2).reshape(b * h, n, hd).contiguous()

    fn = flash_fwd_kernel
    if card_path(q) and torch.is_grad_enabled() and \
            (q.requires_grad or k.requires_grad or v.requires_grad):
        fn = flash_fwd_trainable
    out = fn(to_bh(q, t), to_bh(k, tk), to_bh(v, tk), causal=causal,
             window=window, q_offset=q_offset)
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


def _persist_rows(k: torch.Tensor, v: torch.Tensor, t: int, cap: int,
                  cfg) -> tuple[torch.Tensor, torch.Tensor]:
    if cap >= t:
        pad = (0, 0, 0, 0, 0, cap - t)
        kc, vc = F.pad(k, pad), F.pad(v, pad)
    else:
        src = t - 1 - (t - 1 - torch.arange(cap, device=k.device)) % cap
        kc, vc = k[:, src], v[:, src]
    return kc.to(cfg.cache_dtype), vc.to(cfg.cache_dtype)


def _persist_cache(k: torch.Tensor, v: torch.Tensor, t: int, cap: int,
                   cfg) -> dict:
    """Prefill K/V persistence: the first ``t`` slots hold positions
    [0, t) when the cache holds them all; else the last ``cap`` positions,
    circularly addressed (position p in slot p % cap).  Under a mesh k and
    v are DTensors: each rank pads or gathers its own batch rows, and the
    cache comes back sequence-sharded (`CACHE_AXES`, reference
    ``attention.py:187``)."""
    if shd.current() is None:
        kc, vc = _persist_rows(k, v, t, cap, cfg)
        return {"k": kc, "v": vc}
    axes = ("batch", None, None, None)
    kc, vc = _persist_rows(shd.local(k, axes), shd.local(v, axes), t, cap,
                           cfg)
    shape = (k.shape[0], cap, *k.shape[2:])
    return {"k": logical(shd.from_local(kc, axes, shape), CACHE_AXES["k"]),
            "v": logical(shd.from_local(vc, axes, shape), CACHE_AXES["v"])}


def _project_qkv(params: dict, x: torch.Tensor, cfg
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if shd.current() is not None:
        return _project_qkv_mesh(params, x, cfg)

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


def _project_qkv_mesh(params: dict, x: torch.Tensor, cfg
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The projections on each rank's shards: its batch rows of x against
    its heads of wq / wk / wv (``fsdp`` gathered), q, k and v laid out
    ``("batch", "seq", heads, "head_dim")``: no sum crosses a rank.

    Under ``attn_sharding="sp"`` where the heads do not divide their mesh
    dim (`sharding.spec_for` leaves them whole: Qwen1.5-4B's 20 heads on
    a model dim of 16), each rank projects only its block of the
    sequence (``seq_sp``), all heads of it, so that no two ranks project
    the same rows; `_prefill_mesh` gathers k and v over the model dim
    from there.  Where the heads divide, the sequence stays whole."""
    b, t, d = x.shape
    seq = _project_seq_axis(cfg)
    xl = shd.local(x, ("batch", seq, None))
    sub = {k: v for k, v in params.items() if k not in ("wq", "wk", "wv")}
    heads = {"q": "heads", "k": "kv_heads", "v": "kv_heads"}
    for name, ax in heads.items():
        sub["w" + name] = shd.local(params["w" + name], (None, ax, None))
        if cfg.qkv_bias:
            sub["b" + name] = shd.local(params["b" + name], (ax, None))
    for name in ("q_norm", "k_norm"):
        if name in params:
            sub[name] = shd.local(params[name], (None,))
    with shd.use_mesh_free():
        out = _project_qkv(sub, xl, cfg)
    return tuple(
        shd.from_local(o, ("batch", seq, heads[n], "head_dim"),
                       (b, t, cfg.n_heads if n == "q" else cfg.n_kv_heads,
                        cfg.head_dim))
        for n, o in zip("qkv", out))


def _project_seq_axis(cfg) -> str:
    """The logical axis of the sequence for the projections: ``seq_sp``
    under ``sp`` where the heads stay whole on every rank, else ``seq``
    (whole)."""
    if cfg.attn_sharding != "sp":
        return "seq"
    ctx = shd.current()
    heads = shd.spec_for(("heads",), mesh=ctx.mesh, rules=ctx.rules,
                         shape=(cfg.n_heads,))[0]
    return "seq_sp" if heads is None else "seq"


def _decode_scores(qg: torch.Tensor, k_cache: torch.Tensor
                   ) -> torch.Tensor:
    """Queries (B, KV, G, hd) against the cache (B, cap, KV, hd) -> (B, KV,
    G, cap) f32 dot products, summed in f32: the reference's
    ``preferred_element_type=f32``.  On the card a bf16 or f16 cache is
    read in place: one ``bmm`` a batch row over a strided view of the
    cache, f32 out (``aten::bmm.dtype``), so no copy of it is made (and
    so on meta, `core.device.card_path`).  On the CPU both operands are
    taken to f32, the same function (each product of two bf16 values is
    exact in f32)."""
    if not card_path(k_cache) or k_cache.dtype == torch.float32 \
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
        if shd.current() is not None:
            return _decode_mesh(params, x, q, k, v, cache, pos, cfg, window)
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
    if shd.current() is not None:
        return _prefill_mesh(params, x, q, k, v, positions, cfg, window,
                             cache_capacity)
    q = rope(q, positions, theta=cfg.rope_theta)
    k = rope(k, positions, theta=cfg.rope_theta)
    out = flash_attention(q, repeat_kv(k, cfg.n_heads),
                          repeat_kv(v, cfg.n_heads), causal=cfg.causal,
                          window=window)
    new_cache = None
    if cache_capacity is not None:
        new_cache = _persist_cache(k, v, t, cache_capacity, cfg)
    return _out_proj(out, params, x), new_cache


# --------------------------------------------------------------------------
# under a mesh (reference attention.py:230-340)
# --------------------------------------------------------------------------


def _prefill_mesh(params: dict, x: torch.Tensor, q: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                  cfg, window: int | None, cache_capacity: int | None
                  ) -> tuple[torch.Tensor, dict | None]:
    """Full-sequence attention over DTensors: the reference's layout
    constraints, then the flash kernel on each rank's shard.

    ``attn_sharding="heads"``: q holds this rank's heads over the whole
    sequence.  ``"sp"``: q holds the rank's slice of the sequence
    (``seq_sp`` on the model dim) against the whole K/V, so the kernel
    places its queries at ``q_offset`` = the slice's first position, the
    same function the reference's jnp flash partitions into.  K and V
    are gathered over the model dim, repeated to every head and cut to
    q's heads.  A dim that does not divide over its mesh dims stays whole
    (`sharding.spec_for`), and the kernel then takes it whole.  The
    ``kv_sharded`` demotion is the reference's (``attention.py:273``).
    """
    b, t, _ = x.shape
    seq_ax = "seq_sp" if cfg.attn_sharding == "sp" else "seq"
    ctx = shd.current()
    phys = ctx.rules.get("kv_heads")
    tp = ctx.shape.get(phys, 1) if isinstance(phys, str) else 1
    kv_sharded = cfg.n_kv_heads % max(tp, 1) == 0
    kv_proj_axes = (("batch", seq_ax, "kv_heads", "head_dim") if kv_sharded
                    else ("batch", "seq_sp", None, None))
    q_axes = ("batch", seq_ax, "heads", "head_dim")
    q = logical(q, q_axes)
    k = logical(k, kv_proj_axes)
    v = logical(v, kv_proj_axes)

    # rotary on the shards (it is per position): q at its slice's positions
    spec = shd.spec_for(q_axes, mesh=ctx.mesh, rules=ctx.rules,
                        shape=tuple(q.shape))
    ql = shd.local(q, q_axes)
    q_offset = shd.axis_index(spec[1]) * ql.shape[1]
    ql = rope(ql, positions[q_offset:q_offset + ql.shape[1]],
              theta=cfg.rope_theta)
    kv_axes = ("batch", None, None, None)
    kl = rope(shd.local(k, kv_axes), positions, theta=cfg.rope_theta)
    vl = shd.local(v, kv_axes)
    kr = repeat_kv(kl, cfg.n_heads)
    vr = repeat_kv(vl, cfg.n_heads)
    h_l = ql.shape[2]
    if h_l != cfg.n_heads:
        h0 = shd.axis_index(spec[2]) * h_l
        kr, vr = kr[:, :, h0:h0 + h_l], vr[:, :, h0:h0 + h_l]
    out = flash_attention(ql, kr, vr, causal=cfg.causal, window=window,
                          q_offset=q_offset)
    new_cache = None
    if cache_capacity is not None:
        new_cache = _persist_cache(shd.from_local(kl, kv_axes, k.shape),
                                   shd.from_local(vl, kv_axes, v.shape), t,
                                   cache_capacity, cfg)
    # the output product on the shard: this rank's heads (summed over the
    # heads' mesh dims) of its rows
    wo = shd.local_spec(params["wo"], shd.PartitionSpec(spec[2], None, None))
    y = shd.all_reduce(_out_proj(out, {"wo": wo}, ql), spec[2])
    y = shd.from_local_spec(y, shd.PartitionSpec(spec[0], spec[1], None),
                            tuple(x.shape))
    return logical(y, ("batch", seq_ax, "embed")), new_cache


def _decode_mesh(params: dict, x: torch.Tensor, q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, cache: dict,
                 pos: torch.Tensor, cfg, window: int | None
                 ) -> tuple[torch.Tensor, dict]:
    """One decode step (q and k already rotated) against the sequence-sharded cache (`CACHE_AXES`:
    batch on the data dim, slots on the model dim).

    Each rank writes the new K/V row only where it owns slot pos % cap
    (a masked in-place write: no host sync, so a CUDA graph captures it),
    scores its own slots, and the softmax's max and sum, then the values'
    sum, are reduced over the model dim: the flash-decoding combine that
    the reference leaves to GSPMD (``attention.py:257``).  The output
    projection takes the rank's heads (on the heads' mesh dims) and sums
    their partial products, as the prefill's does.  Where the
    slots are whole on every rank (one rank along the model dim) the
    step is the mesh-free one, op for op."""
    b = x.shape[0]
    hd, kvh = cfg.head_dim, cfg.n_kv_heads
    g = cfg.n_heads // kvh
    ctx = shd.current()
    k_cache, v_cache = cache["k"], cache["v"]
    cap = k_cache.shape[1]
    cspec = shd.spec_for(CACHE_AXES["k"], mesh=ctx.mesh, rules=ctx.rules,
                         shape=tuple(k_cache.shape))
    row_axes = ("batch", None, None, None)
    ql, kl, vl = (shd.local(a, row_axes) for a in (q, k, v))
    kc, vc = k_cache.to_local(), v_cache.to_local()
    cap_l = kc.shape[1]
    off = shd.axis_index(cspec[1]) * cap_l
    slot = (pos % cap - off).reshape(1)
    if cap_l == cap:
        kc.index_copy_(1, slot, kl.to(kc.dtype))
        vc.index_copy_(1, slot, vl.to(vc.dtype))
    else:
        own = (slot >= 0) & (slot < cap_l)
        at = slot.clamp(0, cap_l - 1)
        kc.index_copy_(1, at, torch.where(own, kl.to(kc.dtype),
                                          kc.index_select(1, at)))
        vc.index_copy_(1, at, torch.where(own, vl.to(vc.dtype),
                                          vc.index_select(1, at)))
    qg = ql.reshape(ql.shape[0], kvh, g, hd)
    scores = _decode_scores(qg, kc) * (hd ** -0.5)
    kpos = pos - (pos - (off + torch.arange(cap_l, device=kc.device))) % cap
    valid = kpos >= 0
    if window is not None:
        valid &= pos - kpos < window
    scores = torch.where(valid, scores, NEG_INF)
    if shd.axis_size(cspec[1]) == 1:
        out = _decode_values(torch.softmax(scores, dim=-1), vc)
    else:
        m = shd.all_reduce(scores.amax(-1, keepdim=True), cspec[1], "max")
        e = torch.exp(scores - m)
        l = shd.all_reduce(e.sum(-1, keepdim=True), cspec[1])
        out = shd.all_reduce(_decode_values(e, vc), cspec[1]) / l
    # the out-projection split over the heads' mesh dims, its partial
    # sums reduced (as the prefill's), not repeated on every rank
    hspec = shd.spec_for(("heads",), mesh=ctx.mesh, rules=ctx.rules,
                         shape=(cfg.n_heads,))[0]
    h_l = cfg.n_heads // shd.axis_size(hspec)
    h0 = shd.axis_index(hspec) * h_l
    out = out.to(x.dtype).reshape(ql.shape[0], 1, cfg.n_heads, hd)
    if h_l != cfg.n_heads:
        out = out[:, :, h0:h0 + h_l]
    wo = shd.local_spec(params["wo"], shd.PartitionSpec(hspec, None, None))
    y = shd.all_reduce(_out_proj(out, {"wo": wo}, out), hspec)
    y = shd.from_local(y, ("batch", None, None), (b, 1, x.shape[2]))
    return logical(y, ("batch", None, "embed")), {"k": k_cache,
                                                  "v": v_cache}
