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

The port has no mesh: it runs the reference's ``ctx is None`` path, on
which the reference sums the tp shards' f32 products one after the
other.  `merge_wo` makes the tp shard CSRs one CSR over K = F: strip j
stores shard 0's S_o tiles, then shard 1's, and so on, with shard r's
K-tile ids moved up by r x F/tp/vk_o.  Its product adds the same
products, shard by shard in the same order, into one f32 accumulator
where the reference starts each shard from zero and adds the shards'
sums: only the f32 rounding differs.  `prepare_sparse_mlp` merges once,
when the weights are placed (`transformer.prepare_params`, the
`Server`); `sparse_mlp_apply` takes the merged tree or the reference's.

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

from repro_torch.core.vector_sparse import VectorSparse
from repro_torch.kernels.vsmm import vsmm_kernel
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
    ``wo_csr_vals`` / ``wo_csr_idx`` (`merge_wo`).  A tree already in
    that form is returned as it is."""
    if "wo_csr_vals" in params:
        return params
    vals, idx = merge_wo(params["wo_vals"], params["wo_idx"], cfg.d_ff)
    return {"wi_vals": params["wi_vals"], "wi_idx": params["wi_idx"],
            "wo_csr_vals": vals, "wo_csr_idx": idx}


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
