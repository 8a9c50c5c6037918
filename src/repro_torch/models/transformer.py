"""Pattern-based LM stack: segments of repeated homogeneous layer groups.

The port of `repro/models/transformer.py` for attention + MLP layers.  An
architecture is a list of `Segment`s; each repeats a tuple of `LayerSpec`s
(mixer x ffn x window), and its params (and caches) are stacked on a
leading axis of size ``repeat``, with the reference's nesting — so the
weights bridge maps the reference's tree one to one.  Where the reference
runs `lax.scan` over that axis, the port runs a Python loop and indexes
the stacked tensors (views, not copies).

Modes:
  train   — full-sequence forward (no caches)
  prefill — forward + populated decode caches
  decode  — one token through the caches at position ``pos``; the port
            updates the caches in place and returns the same tree
"""
from __future__ import annotations

import torch

from .attention import attention_apply, attn_schema, init_kv_cache
from .layers import P, mlp_apply, mlp_schema, rms_norm, stack

__all__ = ["lm_schema", "layer_schema", "init_cache", "apply_layer",
           "forward_hidden", "embed_tokens", "unembed_matrix", "lm_apply",
           "prefill", "decode_step"]


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------


def layer_schema(spec, cfg) -> dict:
    d = cfg.d_model
    s = {}
    if spec.mixer != "none":
        s["ln1"] = P((d,), (None,), init="zeros")
        s["mix"] = attn_schema(cfg)
    if spec.ffn != "none":
        s["ln2"] = P((d,), (None,), init="zeros")
        s["ffn"] = mlp_schema(d, cfg.d_ff, cfg.activation)
    return s


def lm_schema(cfg) -> dict:
    d, vp = cfg.d_model, cfg.padded_vocab
    s = {"final_norm": P((d,), (None,), init="zeros"),
         "embed": P((vp, d), ("vocab", "fsdp"), init="embed")}
    if not cfg.tie_embeddings:
        s["out_head"] = P((d, vp), ("fsdp", "vocab"), fan_in=d)
    s["segments"] = [
        stack({f"l{i}": layer_schema(sp, cfg) for i, sp in enumerate(seg.layers)},
              seg.repeat)
        for seg in cfg.segments
    ]
    return s


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _stacked(tree: dict, n: int) -> dict:
    """A tree of tensors -> zeros with a leading axis of size n."""
    if isinstance(tree, torch.Tensor):
        return tree.new_zeros((n, *tree.shape))
    return {k: _stacked(v, n) for k, v in tree.items()}


def init_cache(cfg, batch: int, capacity: int, device: torch.device,
               dtype: torch.dtype | None = None) -> list:
    """Decode caches: one stacked tree per segment (leading dim = repeat)."""
    dtype = dtype or cfg.cache_dtype
    caches = []
    for seg in cfg.segments:
        group = {}
        for i, sp in enumerate(seg.layers):
            slot = {}
            if sp.mixer == "attn":
                cap = min(capacity, sp.window) if sp.window else capacity
                slot["mix"] = init_kv_cache(cfg, batch, cap, dtype, device)
            group[f"l{i}"] = slot
        caches.append(_stacked(group, seg.repeat))
    return caches


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply_layer(p: dict, h: torch.Tensor, spec, cfg, *, mode: str,
                cache: dict | None = None, pos: int | None = None,
                capacity: int | None = None) -> tuple[torch.Tensor, dict]:
    """One (mixer, ffn) residual layer. Returns (h, new_cache)."""
    new_cache = {}
    cache = cache or {}
    if spec.mixer != "none":
        inp = rms_norm(h, p["ln1"])
        cap = None
        if mode == "prefill":
            cap = min(capacity, spec.window) if spec.window else capacity
        out, nc = attention_apply(
            p["mix"], inp, cfg, window=spec.window, cache=cache.get("mix"),
            pos=pos, decode=mode == "decode", cache_capacity=cap)
        h = h + out
        if nc is not None:
            new_cache["mix"] = nc
    if spec.ffn != "none":
        inp = rms_norm(h, p["ln2"])
        h = h + mlp_apply(p["ffn"], inp, activation=cfg.activation)
    return h, new_cache


def _index(tree, r: int):
    """Layer ``r`` of a stacked tree: views of every leaf."""
    if isinstance(tree, torch.Tensor):
        return tree[r]
    return {k: _index(v, r) for k, v in tree.items()}


def _store(dst: dict, src: dict, r: int) -> None:
    """Copy one layer's cache tree into slot ``r`` of a stacked tree."""
    for k, v in src.items():
        if isinstance(v, torch.Tensor):
            dst[k][r].copy_(v)
        else:
            _store(dst[k], v, r)


def forward_hidden(params: dict, x: torch.Tensor, cfg, *, mode: str = "train",
                   caches: list | None = None, pos: int | None = None,
                   capacity: int | None = None
                   ) -> tuple[torch.Tensor, list]:
    """x (B, T, D) embeddings -> (h, caches).  Prefill allocates and fills
    fresh stacked caches; decode updates ``caches`` in place."""
    h = x
    out_caches = []
    if mode == "prefill":
        caches = init_cache(cfg, x.shape[0], capacity, x.device)
    for si, seg in enumerate(cfg.segments):
        p_seg = params["segments"][si]
        c_seg = caches[si] if caches is not None else None
        for r in range(seg.repeat):
            p_group = _index(p_seg, r)
            for i, sp in enumerate(seg.layers):
                key = f"l{i}"
                h, nc = apply_layer(
                    p_group[key], h, sp, cfg, mode=mode,
                    cache=_index(c_seg[key], r) if mode == "decode" else None,
                    pos=pos, capacity=capacity)
                if mode == "prefill":
                    _store(c_seg[key], nc, r)
        out_caches.append(c_seg)
    h = rms_norm(h, params["final_norm"])
    return h, out_caches


# ---------------------------------------------------------------------------
# token embedding / logits / serve steps
# ---------------------------------------------------------------------------


def embed_tokens(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    h = params["embed"][tokens]
    # the scale rounded to h's dtype first, as the reference's asarray;
    # made on the device (a fill, not a blocking host-to-device copy)
    return h * torch.full((), cfg.d_model ** 0.5, dtype=h.dtype,
                          device=h.device)


def unembed_matrix(params: dict, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["out_head"]


def _logits(h: torch.Tensor, params: dict, cfg) -> torch.Tensor:
    """(B, T, D) -> (B, T, Vp) f32 logits: an f32 product of the values,
    as the reference's ``preferred_element_type=f32``."""
    return torch.matmul(h.float(), unembed_matrix(params, cfg).float())


def lm_apply(params: dict, batch: dict, cfg) -> torch.Tensor:
    """Plain forward to all-position logits (B, T, Vp)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    h, _ = forward_hidden(params, x, cfg, mode="train")
    return _logits(h, params, cfg)


def prefill(params: dict, batch: dict, cfg, *, capacity: int,
            logit_pos: int | None = None) -> tuple[torch.Tensor, list]:
    """Full-context forward; returns (logits (B, Vp), caches).

    Logits are read at the last position by default; ``logit_pos`` reads
    them at a chosen position instead — the hook that lets a backfill
    prefill right-pad its context up to a bucketed length while still
    emitting the token after the true context end.  The right-pad junk
    beyond ``logit_pos`` is causally masked for the logits and its K/V
    rows are overwritten by later decode steps before any query attends
    them.
    """
    x = embed_tokens(params, batch["tokens"], cfg)
    h, caches = forward_hidden(params, x, cfg, mode="prefill",
                               capacity=capacity)
    t = h.shape[1] - 1 if logit_pos is None else logit_pos
    return _logits(h[:, t:t + 1], params, cfg)[:, 0], caches


def decode_step(params: dict, caches: list, tokens: torch.Tensor, pos: int,
                cfg) -> tuple[torch.Tensor, list]:
    """One decode step. tokens (B, 1) integer, pos an int.

    Returns (logits (B, Vp), caches), the caches updated in place.
    """
    x = embed_tokens(params, tokens, cfg)
    h, caches = forward_hidden(params, x, cfg, mode="decode", caches=caches,
                               pos=pos)
    return _logits(h, params, cfg)[:, 0], caches
