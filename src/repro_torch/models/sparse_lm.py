"""Vector-sparse FFN for the LM: the paper's weight-vector skip applied to
the transformer's MLP.

The port of `repro/models/sparse_lm.py`.  Weights are stored in the
balanced block-CSR of `core.vector_sparse` (only the stored (vk, vn)
tiles exist, so products and weight bytes scale with the density), with
the reference's tensor-parallel layout:

  wi  (D, F):  ``wi_vals`` (NB_i, S_i, vk, vn), ``wi_idx`` (NB_i, S_i),
               with a leading (gate, up) dim of 2 for a gated FFN;
  wo  (F, D):  K = F cut into ``tp_hint`` shard-local CSRs, each over
               its own F/tp K-range: ``wo_vals`` (tp, NB_o, S_o, vk_o,
               vn_o), ``wo_idx`` (tp, NB_o, S_o).

Without a mesh the port runs the reference's ``ctx is None`` path, on
which the reference sums the tp shards' f32 products one after the
other.  `merge_wo` makes the tp shard CSRs one CSR over K = F: strip j
stores shard 0's S_o tiles, then shard 1's, and so on, with shard r's
K-tile ids moved up by r x F/tp/vk_o.  Its product adds the same
products, shard by shard in the same order, into one f32 accumulator
where the reference starts each shard from zero and adds the shards'
sums: only the f32 rounding differs.  `prepare_sparse_mlp` merges once,
when the weights are placed (`transformer.prepare_params`, the
`Server`); `sparse_mlp_apply` takes the merged tree or the reference's.

Under a mesh (`parallel.sharding.use_mesh`) the reference's TP body
(``sparse_lm.py:104-189``): each rank multiplies by its own ``wi``
strips (F split over the model dim) and by its own shard CSRs of ``wo``
(K = its F range), and the partial outputs are summed over the model
dim.  The tp shards are *not* merged across ranks: `prepare_sparse_mlp`
merges only the shards one rank holds (tp_hint / model of them), into
a leading rank dim of the model dim's size, so each rank launches one
``wo`` product.  Where tp_hint equals the model dim's size that is the
reference's tree as it is (its body reads shard ``[0]`` of the rank's
one); where a rank holds several shards the reference's body reads only
the first of them, and the port sums them all (the mesh-free function).
The partial outputs are summed only over the mesh dims that split F:
where neither ``wi``'s strips nor ``wo``'s shards divide over the model
dim, every rank computes the whole product and nothing is summed (the
reference's body sums such replicated outputs over the model dim all
the same).

Each CSR product (`_vs_mm`) is one `kernels.vsmm.vsmm_kernel` call: on
CUDA tensors one launch of ``csrc/vsmm.cu`` (its bf16 branch for the
served bf16 weights, the f32 one for f32 weights), with an f32 output —
the reference's accumulator; on CPU tensors its plain version.  A gated
layer makes 3 launches (gate, up, wo), a plain one 2.  The activation
and the casts follow in PyTorch, as in the reference.  The all-zero
activation tiles that the kernel skips are real after a ReLU or a
squared ReLU (Nemotron-4's relu2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels.vsmm import vsmm_kernel
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import PartitionSpec
from .layers import P

__all__ = ["sparse_mlp_schema", "sparse_mlp_apply", "merge_wo",
           "prepare_sparse_mlp"]

_GATED = ("swiglu", "geglu")


def _s_of(kb: int, density: float) -> int:
    return max(1, round(kb * density))


def _fit(pref: int, dim: int) -> int:
    """Largest divisor of dim <= pref (tile-size guard for small configs)."""
    v = min(pref, dim)
    while dim % v:
        v -= 1
    return v


def sparse_mlp_schema(cfg, sp) -> dict:
    """Schema for a vector-sparse (gated or plain) FFN block."""
    d, f = cfg.d_model, cfg.d_ff
    tp = cfg.tp_hint
    f_loc = f // tp
    gated = cfg.activation in _GATED
    vk, vn = _fit(sp.vk, d), _fit(sp.vn, f_loc)
    nb_i, kb_i = f // vn, d // vk
    s_i = _s_of(kb_i, sp.density)
    vk_o, vn_o = _fit(sp.vk, f_loc), _fit(sp.vn, d)
    nb_o, kb_o = d // vn_o, f_loc // vk_o
    s_o = _s_of(kb_o, sp.density)
    lead = (2,) if gated else ()
    return {
        "wi_vals": P((*lead, nb_i, s_i, vk, vn),
                     (*(None,) * len(lead), "ff", None, None, None),
                     fan_in=d),
        "wi_idx": P((*lead, nb_i, s_i),
                    (*(None,) * len(lead), "ff", None),
                    init="vs_idx", fan_in=kb_i, dtype=torch.int32),
        "wo_vals": P((tp, nb_o, s_o, vk_o, vn_o),
                     ("ff", None, None, None, None), fan_in=f),
        "wo_idx": P((tp, nb_o, s_o), ("ff", None, None),
                    init="vs_idx", fan_in=kb_o, dtype=torch.int32),
    }


def merge_wo(wo_vals: torch.Tensor, wo_idx: torch.Tensor, d_ff: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The tp shard-local CSRs of ``wo`` as one CSR over K = ``d_ff``:
    vals (..., tp, NB, S, vk, vn) -> (..., NB, tp*S, vk, vn), idx (...,
    tp, NB, S) -> (..., NB, tp*S) with shard r's ids + r*KB (KB = d_ff /
    tp / vk, a shard's K-tiles).  Leading dims (a layer stack) are kept."""
    tp, vk = wo_vals.shape[-5], wo_vals.shape[-2]
    kb = d_ff // tp // vk
    shift = torch.arange(tp, dtype=wo_idx.dtype,
                         device=wo_idx.device).reshape(tp, 1, 1) * kb
    vals = wo_vals.movedim(-5, -4)
    idx = (wo_idx + shift).movedim(-3, -2)
    return (vals.reshape(*vals.shape[:-5], vals.shape[-5], -1,
                         *vals.shape[-2:]).contiguous(),
            idx.reshape(*idx.shape[:-3], idx.shape[-3], -1).contiguous())


def prepare_sparse_mlp(params: dict, cfg) -> dict:
    """A sparse FFN's tree (the reference's) in the served form: ``wi_*``
    as they are, ``wo_vals`` / ``wo_idx`` replaced by the merged CSR
    ``wo_csr_vals`` / ``wo_csr_idx`` (`merge_wo`).  Under a mesh (DTensor
    leaves) each rank merges only its own shards (`_merge_local`).  A
    tree already in that form is returned as it is."""
    if "wo_csr_vals" in params:
        return params
    if isinstance(params["wo_vals"], DTensor):
        vals, idx = _merge_local(params["wo_vals"], params["wo_idx"], cfg)
    else:
        vals, idx = merge_wo(params["wo_vals"], params["wo_idx"], cfg.d_ff)
    return {"wi_vals": params["wi_vals"], "wi_idx": params["wi_idx"],
            "wo_csr_vals": vals, "wo_csr_idx": idx}


def _wo_axes(ndim: int, rank_dim: int) -> tuple:
    """``wo``'s logical axes: ``ff`` on the shard (or rank) dim, which
    follows any leading layer-stack dim."""
    return ("stack",) * rank_dim + ("ff",) + (None,) * (ndim - rank_dim - 1)


def _merge_local(wo_vals: DTensor, wo_idx: DTensor, cfg
                 ) -> tuple[DTensor, DTensor]:
    """The tp shard CSRs of ``wo`` (DTensors, the shard dim on the model
    dim) as one CSR a rank: vals (..., n, NB, tp/n*S, vk, vn), idx (...,
    n, NB, tp/n*S), with n the ranks that split the shard dim (1 where
    it is whole); rank r's entry merges its tp/n shards over its F/n
    range (`merge_wo`)."""
    rank_dim = wo_vals.ndim - 5
    spec = shd.spec_for(_wo_axes(wo_vals.ndim, rank_dim),
                        mesh=wo_vals.device_mesh, rules=shd.current().rules,
                        shape=tuple(wo_vals.shape))
    n = shd.axis_size(spec[rank_dim])
    vals, idx = merge_wo(wo_vals.to_local(), wo_idx.to_local(),
                         cfg.d_ff // n)
    vals, idx = vals.unsqueeze(rank_dim), idx.unsqueeze(rank_dim)
    lead = tuple(wo_vals.shape[:rank_dim])

    def place(t: torch.Tensor) -> DTensor:
        shape = (*lead, n, *t.shape[rank_dim + 1:])
        sp = PartitionSpec(*spec[:rank_dim + 1],
                           *(None,) * (len(shape) - rank_dim - 1))
        return shd.from_local_spec(t, sp, shape)

    return place(vals), place(idx)


def _vs_mm(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor
           ) -> torch.Tensor:
    """x (M, KB*vk) x CSR vals (NB, S, vk, vn), idx (NB, S) -> (M, NB*vn)
    f32: one `vsmm_kernel` call.  Products = S/KB x dense: the paper's
    weight-vector skip, structurally."""
    nb, _, _, vn = vals.shape
    vs = VectorSparse(vals=vals, idx=idx, shape=(x.shape[1], nb * vn))
    return vsmm_kernel(x, vs, out_dtype=torch.float32)


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(h)
    if kind in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")
    if kind == "relu2":
        r = torch.relu(h)
        return r * r
    return torch.relu(h)


def sparse_mlp_apply(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D) in x's dtype; ``params`` the reference's
    tree or `prepare_sparse_mlp`'s."""
    if shd.current() is not None:
        return _sparse_mesh(params, x, cfg)
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    if params["wi_vals"].ndim == 5:  # gated: (gate, up)
        gate = _vs_mm(x2, params["wi_vals"][0], params["wi_idx"][0])
        up = _vs_mm(x2, params["wi_vals"][1], params["wi_idx"][1])
        h = (_act(gate, cfg.activation) * up).to(x.dtype)
    else:
        h = _act(_vs_mm(x2, params["wi_vals"], params["wi_idx"]),
                 cfg.activation).to(x.dtype)
    wo = prepare_sparse_mlp(params, cfg)
    y = _vs_mm(h, wo["wo_csr_vals"], wo["wo_csr_idx"])
    return y.reshape(b, t, d).to(x.dtype)


def _sparse_mesh(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The reference's TP body under a mesh: x's batch rows on the batch
    dims (whole where they do not divide), ``wi``'s strips and ``wo``'s
    rank CSR on the model dim; the rank's partial output rounded to x's
    dtype and summed over the mesh dims that split F (reference
    ``sparse_lm.py:104-124``)."""
    ctx = shd.current()
    wo = prepare_sparse_mlp(params, cfg)
    b, t, d = x.shape
    batch = tuple(p for p in ((ctx.rules.get("batch"),)
                              if isinstance(ctx.rules.get("batch"), str)
                              else ctx.rules.get("batch") or ())
                  if p in ctx.shape) or None
    if batch and b % shd.axis_size(batch):
        batch = None
    x_spec = PartitionSpec(batch, None, None)
    gated = params["wi_vals"].ndim == 5
    lead = (None,) if gated else ()
    wi_spec = shd.spec_for((*lead, "ff", None, None, None), mesh=ctx.mesh,
                           rules=ctx.rules,
                           shape=tuple(params["wi_vals"].shape))
    wo_spec = shd.spec_for(_wo_axes(5, 0), mesh=ctx.mesh, rules=ctx.rules,
                           shape=tuple(wo["wo_csr_vals"].shape))
    f_entry = wi_spec[len(lead)]
    if f_entry != wo_spec[0]:
        raise ValueError(
            f"{cfg.name}: wi's strips split over {f_entry!r} but wo's "
            f"shards over {wo_spec[0]!r}; the sparse FFN needs one layout")
    xl = shd.local_spec(x, x_spec)
    x2 = xl.reshape(-1, d)
    wi_vals = shd.local_spec(params["wi_vals"], wi_spec)
    wi_idx = shd.local_spec(params["wi_idx"], PartitionSpec(*wi_spec[:-2]))
    if gated:
        gate = _vs_mm(x2, wi_vals[0], wi_idx[0])
        up = _vs_mm(x2, wi_vals[1], wi_idx[1])
        h = (_act(gate, cfg.activation) * up).to(x.dtype)
    else:
        h = _act(_vs_mm(x2, wi_vals, wi_idx), cfg.activation).to(x.dtype)
    wo_vals = shd.local_spec(wo["wo_csr_vals"], wo_spec)[0]
    wo_idx = shd.local_spec(wo["wo_csr_idx"],
                            PartitionSpec(*wo_spec[:3]))[0]
    y = _vs_mm(h, wo_vals, wo_idx).to(x.dtype)
    shd.all_reduce(y, f_entry)
    return shd.from_local_spec(y.reshape(xl.shape), x_spec, (b, t, d))
