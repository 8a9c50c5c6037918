"""Mixture-of-experts FFN: top-k routing, capacity packing, the combine.

The port of `repro/models/moe.py`: one device (the reference's
``ctx is None`` path), or under a mesh its ``shard_map`` dispatch with
both bodies (`_moe_mesh`).  Every token's router
logits pick its ``top_k`` experts (dead padding experts never win: their
logits are -1e30); the (token, expert) assignments are sorted by expert,
stably, and each expert takes the first ``capacity`` of its own, so an
over-capacity token is dropped from that expert as the reference drops
it (Switch semantics).  The packed (E, C, D) buffer runs through every
expert's FFN as one batched product, and each token's outputs come back
weighted by its normalized router probability.

Everything stays on the device with static shapes: no host sync, no
boolean-mask indexing, no ``nonzero``, so a decode step that routes
through it can be captured as a CUDA graph.  The reference's
``.at[slot].set(mode="drop")`` becomes a scatter into one spare slot
past the end of the buffer, sliced off.  `lax.top_k` breaks ties by the
lower index: a stable descending sort does the same.

The combine reads, for each (token, j) assignment, its slot's output (a
zero row where the assignment was dropped) and sums the ``top_k`` of a
token in f32 in a fixed order: a gather and a reduction, no atomics, so
the same inputs give the same bits on every launch (the reference's
scatter-add of slot outputs into token rows sums the same terms).

Matmul output precision (`layers.matmul_out_dtype`; reference
``moe.py:66``): the expert products emit f32 by default, so gate and
(plain FFN) the hidden stay f32 through the activation; under
``bf16_flow`` they emit the input's dtype, and the activation reads the
rounded gate (widened to f32), as the reference's does.  The down
product is cast back either way.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import PartitionSpec

from .layers import P, matmul_out

__all__ = ["MoEConfig", "moe_schema", "moe_apply", "route_and_pack",
           "capacity"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    n_shared: int = 0  # shared-expert width multiplier (kimi-k2: 1)
    aux_weight: float = 0.01

    def padded_experts(self, tp: int) -> int:
        return -(-self.n_experts // tp) * tp


def moe_schema(d_model: int, moe: MoEConfig, *, gated: bool,
               tp_hint: int = 16) -> dict:
    ep = moe.padded_experts(tp_hint)
    f = moe.d_ff
    s = {
        "router": P((d_model, ep), ("fsdp", None), fan_in=d_model),
        "wo": P((ep, f, d_model), ("expert", "fsdp", None), fan_in=f),
    }
    if gated:
        s["wi"] = P((2, ep, d_model, f), (None, "expert", None, "fsdp"),
                    fan_in=d_model)
    else:
        s["wi"] = P((ep, d_model, f), ("expert", None, "fsdp"),
                    fan_in=d_model)
    return s


def capacity(tokens: int, moe: MoEConfig) -> int:
    """Slots per expert for a wave of ``tokens`` tokens (the reference's
    `_capacity`): ceil(tokens * top_k / n_experts * capacity_factor),
    rounded up to a multiple of 8, at least 8."""
    c = math.ceil(tokens * moe.top_k / moe.n_experts * moe.capacity_factor)
    return max(8, -(-c // 8) * 8)


@dataclasses.dataclass
class Routing:
    """One wave's routing.  Slot i of the (E * C) buffer reads token
    ``slot_tok[i]`` with combine weight ``slot_w[i]`` (token 0 and weight
    0 where the slot is empty); ``slot_of[n * top_k + j]`` is the slot of
    token n's j-th choice, or E * C where that choice was dropped."""

    slot_tok: torch.Tensor   # (E * C,) int64
    slot_w: torch.Tensor     # (E * C,) f32
    slot_of: torch.Tensor    # (N * top_k,) int64
    aux: torch.Tensor        # () f32, the switch load-balance loss


def route_and_pack(xf: torch.Tensor, router: torch.Tensor, moe: MoEConfig,
                   cap: int, *, e0: int = 0, e_loc: int | None = None
                   ) -> Routing:
    """Top-k routing of xf (N, D) over the router's ep (padded) experts,
    packed into ``cap`` slots for each of the ``e_loc`` local experts
    ``e0 .. e0 + e_loc - 1`` (the reference's `_route_and_pack`; every
    expert by default).  An assignment to another rank's expert gets the
    spare slot, as a dropped one does."""
    n = xf.shape[0]
    ep = router.shape[1]
    e_loc = ep if e_loc is None else e_loc
    k = moe.top_k
    dev = xf.device
    logits = xf.float() @ router.float()
    if ep != moe.n_experts:  # dead padding experts never win top-k
        live = torch.arange(ep, device=dev) < moe.n_experts
        logits = torch.where(live, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower index, as the reference's top_k
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    nk = n * k
    ids = topi.reshape(-1)
    wts = topw.reshape(-1)
    ids_s, order = torch.sort(ids, stable=True)
    starts = torch.searchsorted(ids_s, torch.arange(ep, device=dev))
    pos = torch.arange(nk, device=dev) - starts[ids_s]
    spare = e_loc * cap
    if e_loc == ep:
        slot = torch.where(pos < cap, ids_s * cap + pos, spare)
    else:
        mine = (ids_s >= e0) & (ids_s < e0 + e_loc) & (pos < cap)
        slot = torch.where(mine, (ids_s - e0) * cap + pos, spare)
    slot_tok = torch.zeros(spare + 1, dtype=torch.int64, device=dev)
    slot_tok.scatter_(0, slot, order // k)
    slot_w = torch.zeros(spare + 1, dtype=torch.float32, device=dev)
    slot_w.scatter_(0, slot, wts[order])
    slot_of = torch.empty(nk, dtype=torch.int64, device=dev)
    slot_of.scatter_(0, order, slot)

    # switch-style load-balance loss
    ends = torch.cat([starts[1:], starts.new_full((1,), nk)])
    frac = (ends - starts).float() / nk
    aux = moe.n_experts * torch.sum(frac * probs.mean(0))
    return Routing(slot_tok[:spare], slot_w[:spare], slot_of, aux)


def _expert_ffn(xbuf: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, *,
                gated: bool, activation_fn) -> torch.Tensor:
    """xbuf (E, C, D) through every expert's FFN: (E, C, D) in its dtype.
    The products sum in f32 and emit `matmul_out_dtype` (f32, or under
    ``bf16_flow`` the input's dtype); the activation runs in f32."""
    dt = xbuf.dtype
    if gated:
        gate = matmul_out(xbuf, wi[0])
        up = matmul_out(xbuf, wi[1])
        h = activation_fn(gate.float()).to(dt) * up.to(dt)
    else:
        h = activation_fn(matmul_out(xbuf, wi).float()).to(dt)
    return matmul_out(h, wo).to(dt)


def _combine(xf: torch.Tensor, r: Routing, wi: torch.Tensor,
             wo: torch.Tensor, moe: MoEConfig, cap: int, *, gated: bool,
             activation_fn) -> torch.Tensor:
    """The packed tokens through the local experts, weighted and summed
    back per token in f32: (N, D) f32 (the local experts' share)."""
    n, d = xf.shape
    e_loc = r.slot_tok.shape[0] // cap
    xbuf = xf[r.slot_tok].reshape(e_loc, cap, d)
    ybuf = _expert_ffn(xbuf, wi, wo, gated=gated, activation_fn=activation_fn)
    yflat = ybuf.reshape(e_loc * cap, d) * r.slot_w[:, None].to(ybuf.dtype)
    ypad = torch.cat([yflat, yflat.new_zeros((1, d))])
    return ypad[r.slot_of].reshape(n, moe.top_k, d).float().sum(1)


def moe_apply(params: dict, x: torch.Tensor, moe: MoEConfig, *,
              gated: bool, activation_fn=F.silu,
              dispatch: str = "gather_weights"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> (y (B, T, D), aux), with capacity from the wave's
    B * T tokens.  Under a mesh (`parallel.sharding.use_mesh`) the
    reference's sharded dispatch (`_moe_mesh`); ``dispatch`` picks its
    body and means nothing without a mesh, as in the reference."""
    if shd.current() is not None:
        return _moe_mesh(params, x, moe, gated=gated,
                         activation_fn=activation_fn, dispatch=dispatch)
    b, t, d = x.shape
    router, wi, wo = params["router"], params["wi"], params["wo"]
    cap = capacity(b * t, moe)
    xf = x.reshape(b * t, d)
    r = route_and_pack(xf, router, moe, cap)
    y = _combine(xf, r, wi, wo, moe, cap, gated=gated,
                 activation_fn=activation_fn)
    return y.to(x.dtype).reshape(b, t, d), r.aux


def _entries(phys) -> tuple:
    if phys is None:
        return ()
    return tuple(phys) if isinstance(phys, (tuple, list)) else (phys,)


def _sharded(spec: tuple, axis: str | None) -> bool:
    return axis is not None and any(
        e == axis or (isinstance(e, tuple) and axis in e) for e in spec if e)


def _without(spec: tuple, axis: str | None) -> PartitionSpec:
    """``spec`` with mesh dim ``axis`` taken out of every entry: the
    layout after a tiled all-gather over ``axis``."""
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = tuple(a for a in e if a != axis) or None
            e = e[0] if e and len(e) == 1 else e
        elif e == axis:
            e = None
        out.append(e)
    return PartitionSpec(*out)


def _moe_mesh(params: dict, x: torch.Tensor, moe: MoEConfig, *,
              gated: bool, activation_fn, dispatch: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` dispatch (``moe.py:217-273``) over
    DTensors: experts split over the ``expert`` dim (``e0`` = this rank's
    index x ``e_loc``), expert weights' F split over ``fsdp``, tokens on
    the batch dims (replicated where the batch does not divide them).

    ``gather_weights``: each rank routes its own tokens with capacity
    from its *local* token count, the fsdp shards of router, wi and wo
    gathered, and the outputs summed over the expert dim.
    ``resident``: tokens gathered over the batch dims, capacity from all
    of them, each rank's partial expert outputs over its F shard summed
    over the expert and fsdp dims, then each rank keeps its batch rows.
    ``aux`` is averaged over the batch dims.  The routing is the
    one-device port's (stable sort, spare-slot scatter, a gather
    combine in f32)."""
    ctx = shd.current()
    mesh_dims = ctx.shape
    rules = ctx.rules
    model_axis = rules.get("expert")
    model_axis = model_axis if model_axis in mesh_dims else None
    fsdp_axis = rules.get("fsdp")
    fsdp_axis = fsdp_axis if fsdp_axis in mesh_dims else None
    batch_phys = tuple(p for p in _entries(rules.get("batch"))
                       if p in mesh_dims) or None
    router, wi, wo = params["router"], params["wi"], params["wo"]
    tp = mesh_dims[model_axis] if model_axis else 1
    ep = router.shape[1]
    e_loc = ep // tp
    b, t, d = x.shape
    dp = math.prod(mesh_dims[p] for p in (batch_phys or ()))
    if b % dp:  # batch too small to shard: replicate
        batch_phys, dp = None, 1
    bl = b // dp

    def spec(axes: tuple, shape: torch.Size) -> PartitionSpec:
        return shd.spec_for(axes, mesh=ctx.mesh, rules=rules,
                            shape=tuple(shape))

    wi_axes = ((None, "expert", None, "fsdp") if gated
               else ("expert", None, "fsdp"))
    x_spec = PartitionSpec(batch_phys, None, None)
    r_spec = spec(("fsdp", None), router.shape)
    wi_spec = spec(wi_axes, wi.shape)
    wo_spec = spec(("expert", "fsdp", None), wo.shape)
    e0 = shd.axis_index(model_axis) * e_loc
    if dispatch == "resident":
        fsdp_psum = fsdp_axis if _sharded(wi_spec, fsdp_axis) else None
        xg = shd.local_spec(x, PartitionSpec(None, None, None))
        router_l = shd.local_spec(router, _without(r_spec, fsdp_axis))
        wi_l, wo_l = shd.local_spec(wi, wi_spec), shd.local_spec(wo, wo_spec)
        ng = b * t
        cap = capacity(ng, moe)
        xf = xg.reshape(ng, d)
        r = route_and_pack(xf, router_l, moe, cap, e0=e0, e_loc=e_loc)
        y = _combine(xf, r, wi_l, wo_l, moe, cap, gated=gated,
                     activation_fn=activation_fn)
        y = shd.all_reduce(y, model_axis)
        y = shd.all_reduce(y, fsdp_psum)
        y = y.to(x.dtype)
        if batch_phys:
            my = shd.axis_index(batch_phys)
            y = y[my * bl * t:(my + 1) * bl * t]
    elif dispatch == "gather_weights":
        xl = shd.local_spec(x, x_spec)
        router_l = shd.local_spec(router, _without(r_spec, fsdp_axis))
        wi_l = shd.local_spec(wi, _without(wi_spec, fsdp_axis))
        wo_l = shd.local_spec(wo, _without(wo_spec, fsdp_axis))
        cap = capacity(bl * t, moe)
        xf = xl.reshape(bl * t, d)
        r = route_and_pack(xf, router_l, moe, cap, e0=e0, e_loc=e_loc)
        y = _combine(xf, r, wi_l, wo_l, moe, cap, gated=gated,
                     activation_fn=activation_fn).to(x.dtype)
        y = shd.all_reduce(y, model_axis)
    else:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    aux = r.aux
    if batch_phys:
        aux = shd.all_reduce(aux.clone(), batch_phys) / dp
    y = shd.from_local_spec(y.reshape(bl, t, d), x_spec, (b, t, d))
    aux = shd.from_local_spec(aux, PartitionSpec(), ())
    return y, aux
