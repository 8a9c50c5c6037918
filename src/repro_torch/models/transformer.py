"""Pattern-based LM stack: segments of repeated homogeneous layer groups.

The port of `repro/models/transformer.py`.  An architecture is a list of
`Segment`s; each repeats a tuple of `LayerSpec`s (mixer x ffn x window):
mixers ``attn`` (`attention`), ``mamba`` (`mamba`) and ``rwkv_tm``
(`rwkv`), FFNs ``mlp`` (`layers.mlp_apply`, or with ``use_sparse_ffn``
the vector-sparse `sparse_lm`), ``moe`` (`moe`, with the shared expert
``ffn_shared`` where the config has one) and ``rwkv_cm``.  A segment's
params (and caches) are stacked on a leading axis of size ``repeat``,
with the reference's nesting — so the weights bridge maps the
reference's tree one to one.  Where the reference runs `lax.scan` over
that axis, the port runs a Python loop and indexes the stacked tensors
(views, not copies).  Each layer returns the MoE load-balance loss
``aux`` (0 without a MoE), summed over the stack as the reference sums
it.

Inputs: token ids (``{"tokens": (B, T)}``), embedded and scaled by
sqrt(d_model), or with ``embed_inputs=False`` (the stub frontends of
HuBERT and InternVL2, `frontend`) embeddings ``{"embeds": (B, T, D)}``
taken in the config's dtype; such a tree has no ``embed`` and always an
``out_head``.  `decode_step` then takes a (B, 1, D) embedding as its
``tokens``, as the reference's does.  Every entry runs inside
``precision_flow(cfg.bf16_flow)`` (`layers`).  `prepare_params` gives a
tree its served form (each sparse FFN's ``wo`` merged once,
`sparse_lm.prepare_sparse_mlp`); the entries take either form.

`loss_fn` is the training loss (the reference's): the chunked
cross-entropy (`parallel.losses`) plus the MoE's ``aux_weight * aux``;
with ``cfg.remat`` each repeat of a segment's layer group is
checkpointed (`torch.utils.checkpoint`, as the reference checkpoints its
scan body) and its recompute re-enters ``precision_flow`` itself, since
the backward runs outside the entry's context.

Under a mesh (`parallel.sharding.use_mesh`, the `Server`'s ``mesh``) the
params are DTensors (`shard_params`: the schema's logical axes), the
entries lay the inputs and residual stream out as the reference's
`logical` sites do, the caches are DTensors (`cache_axes`), and the
products run on each rank's shards (the embedding, the logits, and the
modules' own mesh paths); plain tensors made inside meet DTensors as
replicated ones (`sharding.mesh_ops`).  `loss_fn` trains under a mesh
the same way (the vocab-sharded loss, `parallel.losses`): each layer's
params are the stack's local shard unbound and wrapped back
(`_unstack`), and the gradients follow `parallel.sharding`'s convention,
so each param's gradient is the global one.

Modes:
  train   — full-sequence forward (no caches)
  prefill — forward + populated decode caches (attention K/V, the
            recurrent mixers' states)
  decode  — one token through the caches at position ``pos`` (a 0-d
            int64 tensor on the device, so one CUDA graph serves every
            step); the port updates every cache in place and returns the
            same tree
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor, Shard

from repro_torch.parallel import sharding as shd
from repro_torch.parallel.losses import chunked_cross_entropy
from repro_torch.parallel.sharding import logical
from repro_torch.utils.cost import uncounted

from .attention import (CACHE_AXES, attention_apply, attn_schema,
                        decode_position, init_kv_cache)
from .layers import (P, axes_tree, matmul_f32, mlp_apply, mlp_schema,
                     precision_flow, rms_norm, stack)
from .mamba import (MAMBA_CACHE_AXES, init_mamba_cache, mamba_apply,
                    mamba_schema)
from .moe import moe_apply, moe_schema
from .rwkv import (RWKV_CM_CACHE_AXES, RWKV_TM_CACHE_AXES,
                   init_rwkv_cm_cache, init_rwkv_tm_cache, rwkv_channel_mix,
                   rwkv_cm_schema, rwkv_time_mix, rwkv_tm_schema)
from .sparse_lm import (prepare_sparse_mlp, sparse_mlp_apply,
                        sparse_mlp_schema)

__all__ = ["lm_schema", "layer_schema", "init_cache", "cache_axes",
           "apply_layer", "forward_hidden", "embed_tokens", "unembed_matrix",
           "lm_apply", "loss_fn", "prefill", "decode_step", "prepare_params",
           "shard_params"]


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------


def _gated(cfg) -> bool:
    return cfg.activation in ("swiglu", "geglu")


def _sparse_ffn(cfg) -> bool:
    return cfg.use_sparse_ffn and cfg.sparsity is not None


def _act_fn(cfg):
    if cfg.activation == "swiglu":
        return F.silu
    return lambda g: F.gelu(g, approximate="tanh")


_MIXER_SCHEMAS = {"attn": attn_schema, "mamba": mamba_schema,
                  "rwkv_tm": rwkv_tm_schema}


def layer_schema(spec, cfg) -> dict:
    d = cfg.d_model
    s = {}
    if spec.mixer != "none":
        s["ln1"] = P((d,), (None,), init="zeros")
        s["mix"] = _MIXER_SCHEMAS[spec.mixer](cfg)
    if spec.ffn != "none":
        s["ln2"] = P((d,), (None,), init="zeros")
        if spec.ffn == "mlp":
            if _sparse_ffn(cfg):
                s["ffn"] = sparse_mlp_schema(cfg, cfg.sparsity)
            else:
                s["ffn"] = mlp_schema(d, cfg.d_ff, cfg.activation)
        elif spec.ffn == "moe":
            s["ffn"] = moe_schema(d, cfg.moe, gated=_gated(cfg),
                                  tp_hint=cfg.tp_hint)
            if cfg.moe.n_shared:
                s["ffn_shared"] = mlp_schema(
                    d, cfg.moe.d_ff * cfg.moe.n_shared, cfg.activation)
        elif spec.ffn == "rwkv_cm":
            s["ffn"] = rwkv_cm_schema(cfg)
        else:
            raise ValueError(spec.ffn)
    return s


def lm_schema(cfg) -> dict:
    d, vp = cfg.d_model, cfg.padded_vocab
    s = {"final_norm": P((d,), (None,), init="zeros")}
    if cfg.embed_inputs:
        s["embed"] = P((vp, d), ("vocab", "fsdp"), init="embed")
    if not (cfg.tie_embeddings and cfg.embed_inputs):
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


def _slot_cache(spec, cfg, batch: int, capacity: int, dtype: torch.dtype,
                device: torch.device) -> dict:
    slot = {}
    if spec.mixer == "attn":
        cap = min(capacity, spec.window) if spec.window else capacity
        slot["mix"] = init_kv_cache(cfg, batch, cap, dtype, device)
    elif spec.mixer == "mamba":
        slot["mix"] = init_mamba_cache(cfg, batch, dtype, device)
    elif spec.mixer == "rwkv_tm":
        slot["mix"] = init_rwkv_tm_cache(cfg, batch, dtype, device)
    if spec.ffn == "rwkv_cm":
        slot["ffn"] = init_rwkv_cm_cache(cfg, batch, dtype, device)
    return slot


_CACHE_AXES_BY_MIXER = {"attn": CACHE_AXES, "mamba": MAMBA_CACHE_AXES,
                        "rwkv_tm": RWKV_TM_CACHE_AXES}


def cache_axes(cfg) -> list:
    """The logical axes of `init_cache`'s tree (the reference's
    ``cache_axes``), with the leading ``stack`` dim."""
    out = []
    for seg in cfg.segments:
        group = {}
        for i, sp in enumerate(seg.layers):
            slot = {}
            if sp.mixer in _CACHE_AXES_BY_MIXER:
                slot["mix"] = {k: ("stack", *v) for k, v in
                               _CACHE_AXES_BY_MIXER[sp.mixer].items()}
            if sp.ffn == "rwkv_cm":
                slot["ffn"] = {k: ("stack", *v)
                               for k, v in RWKV_CM_CACHE_AXES.items()}
            group[f"l{i}"] = slot
        out.append(group)
    return out


def _sharded_zeros(tree, axes, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return shd.zeros(tuple(tree.shape), axes, dtype=tree.dtype,
                         device=device)
    if isinstance(tree, list):
        return [_sharded_zeros(t, a, device) for t, a in zip(tree, axes)]
    return {k: _sharded_zeros(tree[k], axes[k], device) for k in tree}


def _plain_cache(cfg, batch: int, capacity: int, dtype: torch.dtype,
                 device: torch.device) -> list:
    return [_stacked({f"l{i}": _slot_cache(sp, cfg, batch, capacity, dtype,
                                           device)
                      for i, sp in enumerate(seg.layers)}, seg.repeat)
            for seg in cfg.segments]


def init_cache(cfg, batch: int, capacity: int, device: torch.device,
               dtype: torch.dtype | None = None) -> list:
    """Decode caches: one stacked tree per segment (leading dim = repeat).
    Under a mesh each leaf is a DTensor laid out by `cache_axes` (the
    attention K/V sequence-sharded over the model dim), each rank
    holding only its own shard."""
    dtype = dtype or cfg.cache_dtype
    if shd.current() is None:
        return _plain_cache(cfg, batch, capacity, dtype, device)
    with uncounted():   # the global shapes, on meta: not work
        shapes = _plain_cache(cfg, batch, capacity, dtype,
                              torch.device("meta"))
    return _sharded_zeros(shapes, cache_axes(cfg), device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _residual_axes(cfg, mode: str) -> tuple:
    if cfg.seq_shard_residual and mode != "decode":
        return ("batch", "seq_sp", "embed")
    return ("batch", "seq", "embed")


def apply_layer(p: dict, h: torch.Tensor, spec, cfg, *, mode: str,
                cache: dict | None = None,
                pos: torch.Tensor | int | None = None,
                capacity: int | None = None
                ) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """One (mixer, ffn) residual layer. Returns (h, new_cache, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    new_cache = {}
    cache = cache or {}
    decode = mode == "decode"
    prefill = mode == "prefill"
    if cfg.seq_shard_residual:  # Megatron-SP stream (the reference's knob)
        h = logical(h, _residual_axes(cfg, mode))
    if spec.mixer != "none":
        inp = rms_norm(h, p["ln1"])
        if spec.mixer == "attn":
            cap = None
            if prefill:
                cap = min(capacity, spec.window) if spec.window else capacity
            out, nc = attention_apply(
                p["mix"], inp, cfg, window=spec.window,
                cache=cache.get("mix"), pos=pos, decode=decode,
                cache_capacity=cap)
        elif spec.mixer == "mamba":
            out, nc = mamba_apply(p["mix"], inp, cfg, cache=cache.get("mix"),
                                  decode=decode, prefill=prefill)
        else:  # rwkv_tm
            out, nc = rwkv_time_mix(p["mix"], inp, cfg,
                                    cache=cache.get("mix"), decode=decode,
                                    prefill=prefill)
        h = h + out
        if nc is not None:
            new_cache["mix"] = nc
    if spec.ffn != "none":
        inp = rms_norm(h, p["ln2"])
        if spec.ffn == "mlp":
            if _sparse_ffn(cfg):
                out = sparse_mlp_apply(p["ffn"], inp, cfg)
            else:
                out = mlp_apply(p["ffn"], inp, activation=cfg.activation)
        elif spec.ffn == "moe":
            out, aux = moe_apply(p["ffn"], inp, cfg.moe, gated=_gated(cfg),
                                 activation_fn=_act_fn(cfg),
                                 dispatch=cfg.moe_dispatch)
            if cfg.moe.n_shared:
                out = out + mlp_apply(p["ffn_shared"], inp,
                                      activation=cfg.activation)
        else:  # rwkv_cm
            out, nc = rwkv_channel_mix(p["ffn"], inp, cfg,
                                       cache=cache.get("ffn"), decode=decode,
                                       prefill=prefill)
            if nc is not None:
                new_cache["ffn"] = nc
        h = h + out
    return h, new_cache, aux


def _index(tree, r: int):
    """Layer ``r`` of a stacked tree: views of every leaf."""
    if isinstance(tree, torch.Tensor):
        return tree[r]
    return {k: _index(v, r) for k, v in tree.items()}


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked param tree, each leaf unbound along
    its stack axis (views).  Under autograd one ``unbind`` a leaf writes
    the whole leaf's gradient once; indexing layer by layer would give
    each layer's gradient a zero-filled copy of the whole stacked leaf.
    A DTensor leaf (under a mesh) unbinds its local shard (the stack dim
    is never sharded) and wraps each layer back with the stack's
    placements, one dim down: a pure relayout, whose gradient is the
    layer's in those placements."""
    if isinstance(tree, DTensor):
        if any(isinstance(p, Shard) and p.dim == 0 for p in tree.placements):
            raise ValueError("a stacked leaf sharded on its stack dim")
        pls = [Shard(p.dim - 1) if isinstance(p, Shard) else p
               for p in tree.placements]
        shape = tuple(tree.shape[1:])
        stride = shd._contiguous_stride(shape)
        return [DTensor.from_local(t, tree.device_mesh, pls,
                                   run_check=False, shape=shape,
                                   stride=stride)
                for t in tree.to_local().unbind(0)]
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    parts = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: v[r] for k, v in parts.items()} for r in range(n)]


def _store(dst: dict, src: dict, r: int) -> None:
    """Copy one layer's cache tree into slot ``r`` of a stacked tree.  A
    DTensor leaf (under a mesh) is copied shard by shard: ``src`` is
    first laid out as slot ``r`` of ``dst`` is."""
    for k, v in src.items():
        if isinstance(v, DTensor):
            want = [Shard(p.dim - 1) if isinstance(p, Shard) else p
                    for p in dst[k].placements]
            if list(v.placements) != want:
                v = v.redistribute(v.device_mesh, want)
            dst[k].to_local()[r].copy_(v.to_local())
        elif isinstance(v, torch.Tensor):
            dst[k][r].copy_(v)
        else:
            _store(dst[k], v, r)


def _train_group(p_group: dict, h: torch.Tensor, seg, cfg,
                 ctx: shd.MeshContext | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One repeat of a segment's layer group in train mode -> (h, aux),
    inside ``precision_flow(cfg.bf16_flow)`` and, under a mesh, the
    forward's mesh ``ctx``: a checkpointed group is recomputed during the
    backward, outside the entry's context (on the card in the autograd
    engine's own thread)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    mesh = (contextlib.nullcontext() if ctx is None
            else shd.use_mesh(ctx.mesh, ctx.rules))
    with precision_flow(cfg.bf16_flow), mesh, shd.mesh_ops():
        for i, sp in enumerate(seg.layers):
            h, _, a = apply_layer(p_group[f"l{i}"], h, sp, cfg, mode="train")
            aux = aux + a
    return h, aux


def forward_hidden(params: dict, x: torch.Tensor, cfg, *, mode: str = "train",
                   caches: list | None = None,
                   pos: torch.Tensor | int | None = None,
                   capacity: int | None = None, remat: bool = False
                   ) -> tuple[torch.Tensor, list, torch.Tensor]:
    """x (B, T, D) embeddings -> (h, caches, aux).  Prefill fills
    ``caches`` in place when given (caches the caller owns, as
    `init_cache` makes them; every slot is overwritten), else fresh ones;
    decode updates ``caches`` in place.  ``remat`` (train mode) keeps no
    activation inside a repeat of a layer group for the backward: the
    group is recomputed then."""
    h = logical(x, _residual_axes(cfg, mode))
    out_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "prefill" and caches is None:
        caches = init_cache(cfg, x.shape[0], capacity, x.device)
    for si, seg in enumerate(cfg.segments):
        p_seg = params["segments"][si]
        c_seg = caches[si] if caches is not None else None
        groups = _unstack(p_seg, seg.repeat)
        for r in range(seg.repeat):
            p_group = groups[r]
            if remat and mode == "train":
                h, a = checkpoint(_train_group, p_group, h, seg, cfg,
                                  shd.current(), use_reentrant=False,
                                  preserve_rng_state=False)
                aux = aux + a
                continue
            for i, sp in enumerate(seg.layers):
                key = f"l{i}"
                h, nc, a = apply_layer(
                    p_group[key], h, sp, cfg, mode=mode,
                    cache=_index(c_seg[key], r) if mode == "decode" else None,
                    pos=pos, capacity=capacity)
                aux = aux + a
                if mode == "prefill":
                    _store(c_seg[key], nc, r)
        out_caches.append(c_seg)
    h = rms_norm(h, params["final_norm"])
    return h, out_caches, aux


# ---------------------------------------------------------------------------
# token embedding / logits / serve steps
# ---------------------------------------------------------------------------


def embed_tokens(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    if shd.current() is not None:
        return _embed_mesh(params, tokens, cfg)
    h = params["embed"][tokens]
    # the scale rounded to h's dtype first, as the reference's asarray;
    # made on the device (a fill, not a blocking host-to-device copy)
    h = h * torch.full((), cfg.d_model ** 0.5, dtype=h.dtype,
                       device=h.device)
    return logical(h, ("batch", "seq", "embed"))


def _embed_mesh(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """The lookup on each rank's shards: its batch rows of ids against its
    vocab rows of the table (``fsdp`` gathered); an id outside the rank's
    rows reads zeros, and the rows are summed over the vocab's mesh dims
    (each id is in one rank's rows, so the sum is exact)."""
    ctx = shd.current()
    embed = params["embed"]
    v_entry = shd.spec_for(("vocab", None), mesh=ctx.mesh, rules=ctx.rules,
                           shape=tuple(embed.shape))[0]
    table = shd.local(embed, ("vocab", None))
    ids = shd.local(tokens, ("batch", None))
    with shd.use_mesh_free():
        if shd.axis_size(v_entry, ctx=ctx) == 1:
            h = embed_tokens({"embed": table}, ids, cfg)
        else:
            v0 = shd.axis_index(v_entry, ctx=ctx) * table.shape[0]
            at = ids - v0
            mine = (at >= 0) & (at < table.shape[0])
            h = table[at.clamp(0, table.shape[0] - 1)] * \
                mine[..., None].to(table.dtype)
            h = shd.all_reduce(h, v_entry, ctx=ctx) * torch.full(
                (), cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    h = shd.from_local(h, ("batch", None, None),
                       (*tokens.shape, embed.shape[1]))
    return logical(h, ("batch", "seq", "embed"))


def unembed_matrix(params: dict, cfg) -> torch.Tensor:
    if cfg.tie_embeddings and cfg.embed_inputs:
        return params["embed"].T
    return params["out_head"]


def _inputs_to_hidden(params: dict, batch: dict, cfg) -> torch.Tensor:
    if cfg.embed_inputs:
        return embed_tokens(params, batch["tokens"], cfg)
    return logical(batch["embeds"].to(cfg.dtype), ("batch", "seq", "embed"))


def prepare_params(params: dict, cfg) -> dict:
    """``params`` in the served form: each vector-sparse FFN's ``wo`` shard
    CSRs merged into one (`sparse_lm.prepare_sparse_mlp`), once, so a
    step launches one kernel for it.  Every other leaf is shared with
    ``params``; a tree without a sparse FFN is returned as it is."""
    if not _sparse_ffn(cfg):
        return params
    segs = []
    for si, seg in enumerate(cfg.segments):
        group = dict(params["segments"][si])
        for i, sp in enumerate(seg.layers):
            if sp.ffn == "mlp":
                layer = dict(group[f"l{i}"])
                layer["ffn"] = prepare_sparse_mlp(layer["ffn"], cfg)
                group[f"l{i}"] = layer
        segs.append(group)
    return {**params, "segments": segs}


def _distribute(tree, axes):
    if isinstance(tree, torch.Tensor):
        return shd.distribute(tree, axes)
    if isinstance(tree, list):
        return [_distribute(t, a) for t, a in zip(tree, axes)]
    return {k: _distribute(tree[k], axes[k]) for k in tree}


def shard_params(params: dict, cfg) -> dict:
    """The full param tree of ``cfg`` (the same on every rank) as DTensors
    laid out by the schema's logical axes under the active mesh
    (`parallel.sharding.distribute`): each rank keeps its own shards.
    Pass the reference's tree, before `prepare_params`."""
    return _distribute(params, axes_tree(lm_schema(cfg)))


def _logits(h: torch.Tensor, params: dict, cfg) -> torch.Tensor:
    """(B, T, D) -> (B, T, Vp) f32 logits, summed in f32 as the
    reference's ``preferred_element_type=f32`` (`matmul_f32`: on the card
    no f32 copy of the unembedding).  Under a mesh each rank multiplies
    its batch rows by its vocab columns (``("batch", "vocab")``)."""
    w = unembed_matrix(params, cfg)
    if shd.current() is None:
        return matmul_f32(h, w)
    y = matmul_f32(shd.local(h, ("batch", None, None)),
                   shd.local(w, (None, "vocab")))
    return shd.from_local(y, ("batch", None, "vocab"),
                          (*h.shape[:2], w.shape[1]))


def loss_fn(params: dict, batch: dict, cfg
            ) -> tuple[torch.Tensor, dict]:
    """Token-level CE (chunked) + MoE aux -> (loss, {"ce", "aux"}), 0-d
    f32 tensors.  ``batch`` holds ``labels`` (B, T) and ``tokens`` (B, T)
    or, with ``embed_inputs=False``, ``embeds`` (B, T, D).  Under a mesh
    the params and the batch are DTensors, and so are the loss and ce
    (replicated; aux too where the config has a MoE): the vocab-sharded
    loss (`parallel.losses`), its gradient the global one
    (`parallel.sharding`'s convention).

    A vector-sparse FFN config raises before any forward: its param tree
    holds int32 K-tile ids, and the reference's ``value_and_grad`` refuses
    integer inputs, so the sparse FFN does not train there either.
    """
    if _sparse_ffn(cfg):
        raise ValueError(
            f"{cfg.name}: the vector-sparse FFN (use_sparse_ffn) does not "
            f"train: its param tree holds int32 K-tile ids (wi_idx, "
            f"wo_idx), and the reference's value_and_grad refuses integer "
            f"inputs, so it has no training step to hold this one to")
    with precision_flow(cfg.bf16_flow), shd.mesh_ops():
        x = _inputs_to_hidden(params, batch, cfg)
        h, _, aux = forward_hidden(params, x, cfg, mode="train",
                                   remat=cfg.remat)
        ce = chunked_cross_entropy(
            h, batch["labels"], unembed_matrix(params, cfg),
            real_vocab=cfg.vocab, chunk=cfg.ce_chunk, z_weight=cfg.z_loss)
        loss = ce
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_weight * aux
        return loss, {"ce": ce, "aux": aux}


def lm_apply(params: dict, batch: dict, cfg) -> torch.Tensor:
    """Plain forward to all-position logits (B, T, Vp)."""
    with precision_flow(cfg.bf16_flow), shd.mesh_ops():
        x = _inputs_to_hidden(params, batch, cfg)
        h, _, _ = forward_hidden(params, x, cfg, mode="train")
        return _logits(h, params, cfg)


def prefill(params: dict, batch: dict, cfg, *, capacity: int,
            logit_pos: int | None = None, caches: list | None = None
            ) -> tuple[torch.Tensor, list]:
    """Full-context forward; returns (logits (B, Vp), caches).  The
    caches are ``caches`` filled in place when given (the caller's, of
    this batch and capacity), else fresh ones.

    Logits are read at the last position by default; ``logit_pos`` reads
    them at a chosen position instead — the hook that lets a backfill
    prefill right-pad its context up to a bucketed length while still
    emitting the token after the true context end.  The right-pad junk
    beyond ``logit_pos`` is causally masked for the logits and its K/V
    rows are overwritten by later decode steps before any query attends
    them.
    """
    with precision_flow(cfg.bf16_flow), shd.mesh_ops():
        x = _inputs_to_hidden(params, batch, cfg)
        h, caches, _ = forward_hidden(params, x, cfg, mode="prefill",
                                      caches=caches, capacity=capacity)
        t = h.shape[1] - 1 if logit_pos is None else logit_pos
        logits = _logits(h[:, t:t + 1], params, cfg)[:, 0]
        return logical(logits, ("batch", "vocab")), caches


def decode_step(params: dict, caches: list, tokens: torch.Tensor,
                pos: torch.Tensor | int, cfg) -> tuple[torch.Tensor, list]:
    """One decode step. tokens (B, 1) integer (with ``embed_inputs=False``
    the embeddings (B, 1, D)), pos a 0-d integer tensor on the tokens'
    device (or an int).

    Returns (logits (B, Vp), caches), the caches updated in place.  With
    a tensor ``pos`` the step waits on nothing from the host, so a CUDA
    graph can capture it.
    """
    pos = decode_position(pos, tokens.device)
    with precision_flow(cfg.bf16_flow), shd.mesh_ops():
        x = embed_tokens(params, tokens, cfg) if cfg.embed_inputs \
            else logical(tokens, ("batch", "seq", "embed"))
        h, caches, _ = forward_hidden(params, x, cfg, mode="decode",
                                      caches=caches, pos=pos)
        logits = _logits(h, params, cfg)[:, 0]
        return logical(logits, ("batch", "vocab")), caches
