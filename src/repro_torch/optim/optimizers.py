"""Optimizers: AdamW (f32 or low-precision moments), AdamW with int8
block-quantized moments, and Adafactor (factored second moment).

The port of `repro/optim/optimizers.py`.  State trees mirror the param
tree and keep the reference's keys (``m``, ``v``, ``count``;
``moments`` with ``mq`` / ``ms`` / ``vq`` / ``vs`` or ``vr`` / ``vc`` /
``v``), so a checkpoint of either side restores into the other.

Where the reference's ``update(grads, state, params, lr)`` returns the
updates u and a new state (the step then adds ``p + u``), the port's
``update_`` writes the new state and ``p + u`` into ``state`` and
``params``, leaf by leaf, so a step holds one leaf's temporaries rather
than a second copy of the state (a 4 B-parameter AdamW state is 32 GB);
AdamW's elementwise update takes a large leaf in `pieces`.  The
arithmetic keeps the reference's operation order (``b1 * m + (1 - b1) *
g`` as a product, a product and a sum; u rounded to the param's dtype
before the add), so the values are the reference's.  ``lr`` is a 0-d
f32 tensor (a schedule's) or a float; the step count lives on the
params' device.  `clip_by_global_norm_` likewise scales the grads in
place.

Under a mesh (training with `launch.step_builders.build_train`'s
``ctx``) params, grads and state are DTensors: every update runs on the
local shards, grads and AdamW's moments in their parameter's placements.
Where a value needs the whole leaf, the local sums are summed over the
mesh dims that *shard* it, never over a dim that replicates it: the
clip's squares (`global_norm`), and Adafactor's row and column means and
its update RMS, divided by the *global* sizes.  Adafactor's factored
moments are laid out by `Optimizer.state_axes` (the reference's
``state_axes``); a moment laid out otherwise than its gradient's rows or
columns is redistributed to them for the update and back.  Where no dim
of more than one rank shards a leaf the update is the mesh-free one, op
for op.  `adamw8bit` quantizes blocks of the whole leaf and takes no
DTensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.parallel import sharding as shd
from repro_torch.utils.tree import leaves, tree_map

__all__ = ["Optimizer", "adamw", "adamw8bit", "adafactor", "global_norm",
           "clip_by_global_norm_", "pieces"]

F32 = torch.float32
PIECE = 1 << 26  # elements a piece of a large leaf's elementwise update


def pieces(*tensors: torch.Tensor) -> Any:
    """Flat views of contiguous tensors of one size, ``PIECE`` elements at
    a time: an elementwise update of a large leaf (Qwen1.5-4B's stacked
    FFN weight is 1.4 G values) in pieces holds its f32 temporaries for
    one piece, not for the leaf."""
    flats = [t.view(-1) for t in tensors]
    for a in range(0, flats[0].numel(), PIECE):
        yield [f[a:a + PIECE] for f in flats]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # update_(grads, state, params, lr): state and params in place
    update_: Callable[[Any, Any, Any, Any], None]
    # state_axes(param axes, param shape) -> the logical axes of its
    # per-parameter state (Adafactor's moments); None: the param's own
    state_axes: Callable[[tuple, tuple], Any] | None = None


def _loc(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _shard_dims(t: torch.Tensor) -> list[int]:
    """The mesh dims of more than one rank that shard DTensor ``t``."""
    if not isinstance(t, DTensor):
        return []
    mesh = t.device_mesh
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and mesh.size(i) > 1]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor); a
    leaf of more than ``PIECE`` values summed piece by piece.  A DTensor
    leaf sums its local shard, then over the mesh dims that shard it (a
    replica is counted once)."""
    total = 0
    for leaf in leaves(tree):
        sq = (torch.sum(torch.square(x.float()))
              for (x,) in pieces(_loc(leaf)))
        dims = _shard_dims(leaf)
        if dims:
            total = total + shd.sum_over(sum(sq), leaf.device_mesh, dims)
        else:
            for v in sq:
                total = total + v
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


@torch.no_grad()
def clip_by_global_norm_(grads: Any, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``
    (each leaf times the f32 scale, cast back to its dtype); returns the
    norm before."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    for leaf in leaves(grads):
        for (g,) in pieces(_loc(leaf)):
            if g.dtype == F32:
                g.mul_(scale)
            else:
                g.copy_((g.float() * scale).to(g.dtype))
    return norm


def _count_powers(count: torch.Tensor, b1: float, b2: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """1 - b1^t and 1 - b2^t in f32, t the (new) step count.  Each power
    of the f32 beta is taken in f64 and rounded once to f32 (the
    correctly rounded f32 power but in a case of one in billions), so
    that the card's ``pow`` and the CPU's give the same bits: an f32
    ``pow`` is within an ulp or two on either, not the same."""
    t = count.to(torch.float64)
    one = torch.ones((), dtype=F32, device=count.device)

    def power(b: float) -> torch.Tensor:
        return torch.pow((one * b).double(), t).to(F32)

    return 1.0 - power(b1), 1.0 - power(b2)


def _moment_(m: torch.Tensor, beta: float, x: torch.Tensor) -> torch.Tensor:
    """m <- beta * m + (1 - beta) * x in f32, in place when m is f32;
    returns the f32 value."""
    m32 = m.float()  # m itself when it is f32
    m32.mul_(beta).add_(x * (1 - beta))
    if m32 is not m:
        m.copy_(m32.to(m.dtype))
    return m32


def _adam_update(m32: torch.Tensor, v32: torch.Tensor, p: torch.Tensor,
                 c1: torch.Tensor, c2: torch.Tensor, eps: float,
                 weight_decay: float, lr: Any,
                 sqrt: Callable[[torch.Tensor], torch.Tensor] = torch.sqrt
                 ) -> torch.Tensor:
    """(-lr * ((m / c1) / (sqrt(v / c2) + eps) + wd * p)) in p's dtype."""
    den = sqrt(v32 / c2).add_(eps)
    upd = (m32 / c1).div_(den)
    del den
    upd.add_(p.float() * weight_decay)
    return upd.mul_(-lr).to(p.dtype)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, on every device: taken in
    f64 and rounded once (f64 carries enough bits that the two roundings
    give the f32 one).  The card's f32 ``torch.sqrt`` is not correctly
    rounded (7,315 of 2^20 random values differ from the CPU's on an
    H100), which `adamw8bit`'s requantization would turn into other
    codes."""
    return torch.sqrt(x.double()).to(x.dtype)


def _make(init: Callable[[Any], Any], leaf_: Callable[..., torch.Tensor],
          consts: Callable[[torch.Tensor], Any],
          state_leaf: Callable[[Any], bool] | None,
          state_axes: Callable[[tuple, tuple], Any] | None = None
          ) -> Optimizer:
    """An `Optimizer` from ``init`` and the in-place per-leaf update
    ``leaf_(g, st, p, lr, consts(count)) -> u`` (``st`` the leaf's state:
    AdamW's (m, v) pair, in `pieces`; a dict of the ``moments`` tree
    whose nodes ``state_leaf`` picks out, whole, with ``p`` and ``g`` as
    given: DTensors under a mesh).  AdamW's pieces are local shards."""

    def update_(grads: Any, state: Any, params: Any, lr: Any) -> None:
        with torch.no_grad():
            count = _loc(state["count"])
            count.add_(1)
            c = consts(count)
            if state_leaf is not None:
                for g, st, p in zip(leaves(grads),
                                    leaves(state["moments"], state_leaf),
                                    leaves(params)):
                    _loc(p).add_(leaf_(g, st, p, lr, c))
                return
            for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                                  leaves(state["v"]), leaves(params)):
                for gc, mc, vc, pc in pieces(_loc(g), _loc(m), _loc(v),
                                             _loc(p)):
                    pc.add_(leaf_(gc, (mc, vc), pc, lr, c))

    return Optimizer(init, update_, state_axes)


def _count(params: Any) -> torch.Tensor:
    first = leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          moment_dtype: torch.dtype = F32) -> Optimizer:
    def init(params: Any) -> dict:
        def zeros(p: torch.Tensor) -> torch.Tensor:
            return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _count(params)}

    def leaf_(g, mv, p, lr, consts):
        m, v = mv
        c1, c2 = consts
        g32 = g.float()
        m32 = _moment_(m, b1, g32)
        v32 = _moment_(v, b2, torch.square(g32))
        return _adam_update(m32, v32, p, c1, c2, eps, weight_decay, lr)

    return _make(init, leaf_, lambda count: _count_powers(count, b1, b2),
                 None)


# ---------------------------------------------------------------------------
# int8 block-quantized AdamW (8-bit optimizer states, Dettmers-style)
# ---------------------------------------------------------------------------

_QBLOCK = 256


def _q8(x32: torch.Tensor, block: int = _QBLOCK
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 codes (NB, block), f32 per-block scales (NB,)).
    Linear symmetric; the tail block is zero-padded."""
    flat = x32.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    # a division by a tensor: CUDA divides by a Python float as a
    # multiply by its reciprocal, which is not the quotient
    q127 = torch.full((), 127.0, dtype=F32, device=blocks.device)
    scale = torch.clamp_min(blocks.abs().amax(dim=1), 1e-12) / q127
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape: tuple) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:n].reshape(shape)


def adamw8bit(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
              weight_decay: float = 0.1) -> Optimizer:
    """AdamW with int8 block-quantized moments: ~4.5 bits a parameter of
    state per moment (int8 + an f32 scale per 256-block) instead of 32.

    The blocks cover the flattened *whole* leaf.  Under a mesh (DTensor
    params and grads) the moments are replicated (`state_axes`, the
    reference's), and each rank dequantizes, updates and requantizes the
    whole leaf from the gathered gradient and param, as the reference's
    GSPMD step computes the global arrays; the update comes back as the
    rank's shard of the param."""

    def init(params: Any) -> dict:
        def state_of(p: torch.Tensor) -> dict:
            nb = -(-p.numel() // _QBLOCK)
            z8 = torch.zeros((nb, _QBLOCK), dtype=torch.int8,
                             device=p.device)
            zs = torch.zeros((nb,), dtype=F32, device=p.device)
            st = {"mq": z8, "ms": zs, "vq": z8.clone(), "vs": zs.clone()}
            if isinstance(p, DTensor):
                rep = [Replicate()] * p.device_mesh.ndim
                st = {k: DTensor.from_local(v, p.device_mesh, rep,
                                            run_check=False)
                      for k, v in st.items()}
            return st
        return {"moments": tree_map(state_of, params),
                "count": _count(params)}

    def leaf_(g, mom, p, lr, consts):
        c1, c2 = consts
        g32 = _whole(g).float()
        pw = _whole(p)
        mom = {k: _loc(v) for k, v in mom.items()}   # replicated: whole
        m = _dq8(mom["mq"], mom["ms"], tuple(p.shape))
        v = _dq8(mom["vq"], mom["vs"], tuple(p.shape))
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        u = _adam_update(m, v, pw, c1, c2, eps, weight_decay, lr,
                         sqrt=_sqrt_rn)
        for name, x in (("m", m), ("v", v)):
            q, s = _q8(x)
            mom[name + "q"].copy_(q)
            mom[name + "s"].copy_(s)
        if isinstance(p, DTensor):
            return shd.place(u, p.device_mesh, tuple(p.placements)
                             ).to_local()
        return u

    def state_axes(axes: tuple, shape: tuple) -> dict:
        return {"mq": (None, None), "ms": (None,),
                "vq": (None, None), "vs": (None,)}

    return _make(init, leaf_, lambda count: _count_powers(count, b1, b2),
                 lambda x: isinstance(x, dict) and "mq" in x, state_axes)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value on every rank (gathered); a plain tensor
    as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018) — factored second moments
# ---------------------------------------------------------------------------


def adafactor(decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, min_dim_factored: int = 128,
              weight_decay: float = 0.0) -> Optimizer:
    """Memory: O(rows + cols) a matrix instead of O(rows * cols).

    Matrices with both trailing dims >= ``min_dim_factored`` factor over
    the last two axes; everything else stores a full second moment.
    """

    def factored(shape: tuple) -> bool:
        return len(shape) >= 2 and shape[-1] >= min_dim_factored and \
            shape[-2] >= min_dim_factored

    def init(params: Any) -> dict:
        def leaf(p: torch.Tensor) -> dict:
            z = lambda s: torch.zeros(s, dtype=F32, device=p.device)
            if factored(p.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"moments": tree_map(leaf, params), "count": _count(params)}

    def leaf_(g, mom, p, lr, beta):
        lay = _Layout(p)
        g32 = _loc(g).float()
        g2 = torch.square(g32).add_(eps)
        nd = g32.ndim
        if factored(p.shape):
            vr_old = lay.get(mom["vr"], nd - 1)
            vc_old = lay.get(mom["vc"], nd - 2)
            vr = beta * vr_old + (1 - beta) * lay.mean(g2, -1, nd - 1)
            vc = beta * vc_old + (1 - beta) * lay.mean(g2, -2, nd - 2)
            r_factor = torch.rsqrt(
                vr / lay.mean(vr, -1, nd - 2, keepdim=True) + eps)
            c_factor = torch.rsqrt(vc + eps)
            upd = g32 * r_factor[..., None] * c_factor[..., None, :]
            lay.put(mom["vr"], vr, nd - 1)
            lay.put(mom["vc"], vc, nd - 2)
        else:
            v = beta * _loc(mom["v"]) + (1 - beta) * g2
            upd = g32 * torch.rsqrt(v + eps)
            _loc(mom["v"]).copy_(v)
        # update clipping (RMS <= clip_threshold)
        rms = torch.sqrt(lay.mean_all(torch.square(upd)) + 1e-30)
        upd = upd / torch.clamp_min(rms / clip_threshold, 1.0)
        if weight_decay:
            upd = upd + weight_decay * _loc(p).float()
        return (-lr * upd).to(p.dtype)

    def state_axes(axes: tuple, shape: tuple) -> dict:
        if factored(shape):
            return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
        return {"v": axes}

    return _make(init, leaf_,
                 lambda count: 1.0 - count.to(F32) ** -decay,  # t^-0.8
                 lambda x: isinstance(x, dict) and ("v" in x or "vr" in x),
                 state_axes)


class _Layout:
    """Adafactor's reductions over a leaf ``p`` (a DTensor under a mesh,
    else a plain tensor): a mean over a dim of the gradient sums the
    local shard, then over the mesh dims of more than one rank that
    shard that dim, and divides by its global size; where none does, it
    is the plain mean.  A factored moment is read and written in the
    layout of the gradient with one dim taken out (`get` / `put`)."""

    def __init__(self, p: torch.Tensor):
        self.dt = isinstance(p, DTensor)
        if self.dt:
            self.mesh, self.pls = p.device_mesh, tuple(p.placements)
            self.shape = tuple(p.shape)

    def _dims(self, gdim: int) -> list[int]:
        """Mesh dims of more than one rank that shard gradient dim gdim."""
        if not self.dt:
            return []
        return [i for i, p in enumerate(self.pls) if isinstance(p, Shard)
                and p.dim == gdim and self.mesh.size(i) > 1]

    def mean(self, x: torch.Tensor, dim: int, gdim: int,
             keepdim: bool = False) -> torch.Tensor:
        """Mean of local ``x`` over its ``dim``, which lies along the
        gradient's dim ``gdim``."""
        dims = self._dims(gdim)
        if not dims:
            return x.mean(dim=dim, keepdim=keepdim)
        s = shd.sum_over(x.sum(dim=dim, keepdim=keepdim), self.mesh, dims)
        return s / self.shape[gdim]

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        dims = [i for d in range(len(self.shape)) for i in self._dims(d)] \
            if self.dt else []
        if not dims:
            return torch.mean(x)
        return shd.sum_over(torch.sum(x), self.mesh, dims) / math.prod(
            self.shape)

    def _without(self, gdim: int) -> tuple:
        """The gradient's placements with its dim ``gdim`` taken out."""
        return tuple(
            Replicate() if isinstance(p, Shard) and p.dim == gdim else
            Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > gdim else p
            for p in self.pls)

    def get(self, m: torch.Tensor, gdim: int) -> torch.Tensor:
        """Moment ``m`` (the gradient without dim ``gdim``) as the local
        shard that lines up with the gradient's."""
        if not self.dt:
            return m
        want = self._without(gdim)
        if tuple(m.placements) != want:
            m = m.redistribute(m.device_mesh, want)
        return m.to_local()

    def put(self, m: torch.Tensor, value: torch.Tensor, gdim: int) -> None:
        """Write ``value`` (laid out as `get` gives it) into moment m."""
        if not self.dt or tuple(m.placements) == self._without(gdim):
            _loc(m).copy_(value)
            return
        full = DTensor.from_local(value, self.mesh, self._without(gdim),
                                  run_check=False, shape=m.shape,
                                  stride=m.stride())
        m.to_local().copy_(full.redistribute(m.device_mesh,
                                             m.placements).to_local())
