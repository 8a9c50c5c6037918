"""Logical-axis sharding: one rules table maps model-code axis names to mesh
axes.

The port of `repro/parallel/sharding.py`, on `torch.distributed`.  Model
code never names a mesh axis.  It annotates tensors with *logical* axis
names (``('batch', 'seq', 'embed')``); the active `MeshRules` maps each
name to a mesh dim (or None = replicated).  A shape-divisibility guard
demotes any dim that does not divide evenly over its mesh dims to
replicated, so 8 KV heads on a 16-way model axis degrade gracefully.

The reference's constructs, and what stands for them here:

* a ``Mesh`` over ``("data", "model")`` -> a
  `torch.distributed.device_mesh.DeviceMesh` with the same dim names
  (`launch.mesh.make_local_mesh`), or the shape-only `AbstractMesh`
  (sizes, no ranks: `spec_for` at 16x16 without 256 processes);
* a ``PartitionSpec`` -> `PartitionSpec`, the same per-tensor-dim tuple
  of mesh dim names (a tuple of names where a dim shards over several);
* a ``NamedSharding`` -> `NamedSharding` (mesh, spec) and its DTensor
  `placements`: per mesh dim ``Shard(d)`` where tensor dim d is on it,
  else ``Replicate()``.  A dim on ``("pod", "data")`` shards on both, the
  first named the major one, as DTensor splits in mesh-dim order;
* ``device_put(x, named_sharding(...))`` -> `distribute` (each rank
  cuts its shard from its own full copy, as ``distribute_tensor`` lays
  it out, with no communication);
* a ``shard_map`` body -> `local` (a DTensor's shard under an in-spec),
  plain tensor code, `from_local` (the out-spec); ``psum`` / ``pmax`` ->
  `all_reduce`, ``axis_index`` -> `axis_index`;
* ``with_sharding_constraint`` in `logical` -> ``DTensor.redistribute``
  to `spec_for`'s placements.  Outside `use_mesh` `logical` returns its
  input, so every mesh-free path keeps its bits.

Used three ways, as in the reference: activation constraints inside model
code (`logical`), param shardings (`sharding_tree`, `distribute`) and
input and output shardings (`named_sharding`).

Gradients (training under a mesh) follow ``shard_map``'s transpose, so
that any body of plain tensor code between `local` and `from_local`
yields the true gradient of the one global loss, which every rank holds
a copy of:

* `local` / `shard_of`: a shard's gradient is *partial* (``Partial()``)
  over every mesh dim of more than one rank along which the input is
  replicated (each rank used its copy for its own rows, heads or vocab
  columns), and summed over those dims where it meets the input's
  layout;
* `from_local` / `wrap`: an output replicated over a mesh dim of more
  than one rank divides its gradient by that dim's size (each rank's
  copy stands for one share of the replicated value);
* `all_reduce` (``psum``): its gradient is the ``psum`` of the
  incoming one.

So a body whose work is duplicated along a dim (every rank computes the
same value) still sums to the true gradient, and a body split along a
dim completes each rank's partial sum.  Without grad (serving) all three
are the plain ops, in place where they were.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.distributed.tensor.experimental import implicit_replication

__all__ = [
    "MeshRules",
    "MeshContext",
    "AbstractMesh",
    "PartitionSpec",
    "NamedSharding",
    "use_mesh",
    "current",
    "logical",
    "spec_for",
    "placements",
    "mesh_shape",
    "named_sharding",
    "sharding_tree",
    "distribute",
    "place",
    "local",
    "shard_of",
    "wrap",
    "sum_over",
    "local_spec",
    "from_local",
    "from_local_spec",
    "zeros",
    "axis_index",
    "axis_size",
    "all_reduce",
    "mesh_ops",
    "use_mesh_free",
    "TRAIN_RULES",
    "SERVE_RULES",
]


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """logical axis name -> mesh axis name(s) or None (replicated).

    The default tables (the reference's posture):
      batch   -> ('pod', 'data')      DP across pods and the in-pod data axis
      heads   -> 'model'              TP attention (when divisible)
      ff/vocab/expert -> 'model'      TP FFN / vocab-sharded logits / EP
      fsdp    -> 'data'               ZeRO-3 param+state sharding dim
      kv_seq  -> 'model'              sequence-sharded KV cache (decode)
      seq_sp  -> 'model'              sequence-parallel attention activations
    """

    rules: tuple[tuple[str, object], ...]

    def get(self, name: str) -> Any:
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def replace(self, **updates: Any) -> "MeshRules":
        d = dict(self.rules)
        d.update(updates)
        return MeshRules(tuple(d.items()))


def _mk(**kw: Any) -> MeshRules:
    return MeshRules(tuple(kw.items()))


# Training posture: DP(+pod) x TP, FSDP over data.
TRAIN_RULES = _mk(
    batch=("pod", "data"),
    seq=None,
    seq_sp="model",
    embed=None,
    heads="model",
    kv_heads="model",
    head_dim=None,
    ff="model",
    vocab="model",
    expert="model",
    fsdp="data",
    kv_seq="model",
    stack=None,
    conv=None,
)

# Serving posture: params stay sharded (TP + fsdp dim over data so 1T fits),
# KV cache sequence-sharded over the model axis (flash-decoding layout).
SERVE_RULES = TRAIN_RULES


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of named dims with sizes and no ranks: what `spec_for` and
    the dry run need of a production mesh (16x16, 2x16x16) that no
    process group here has."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh: DeviceMesh | AbstractMesh) -> dict[str, int]:
    """{dim name: size} of a `DeviceMesh` or an `AbstractMesh`, in mesh
    order (the reference's ``mesh.shape``).  A `DeviceMesh`'s is read
    from ``mesh.shape``, not ``mesh.mesh``, which builds a tensor of the
    ranks on every call (the sharded paths ask a few hundred times a
    layer)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class PartitionSpec(tuple):
    """Per tensor dim: a mesh dim name, a tuple of them, or None."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


_local = threading.local()


@dataclasses.dataclass
class MeshContext:
    mesh: DeviceMesh | AbstractMesh
    rules: MeshRules

    @property
    def shape(self) -> dict[str, int]:
        return mesh_shape(self.mesh)


def current() -> MeshContext | None:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh | AbstractMesh,
             rules: MeshRules = TRAIN_RULES) -> Iterator[MeshContext]:
    """Activate (mesh, rules) for `logical` constraints and the sharded
    model paths, for this thread."""
    prev = current()
    _local.ctx = MeshContext(mesh, rules)
    try:
        yield _local.ctx
    finally:
        _local.ctx = prev


@contextlib.contextmanager
def use_mesh_free() -> Iterator[None]:
    """No mesh within the block: a shard's plain-tensor code runs the
    mesh-free paths."""
    prev = current()
    _local.ctx = None
    try:
        yield
    finally:
        _local.ctx = prev


def _axis_size(shape: dict[str, int], phys: Any) -> int:
    if phys is None:
        return 1
    if isinstance(phys, (tuple, list)):
        n = 1
        for p in phys:
            n *= shape[p]
        return n
    return shape[phys]


def spec_for(axes: tuple, *, mesh: DeviceMesh | AbstractMesh,
             rules: MeshRules, shape: tuple | None = None) -> PartitionSpec:
    """Logical axes -> PartitionSpec, demoting non-divisible dims to None.

    ``axes`` may contain None entries (explicitly replicated dims).  If
    ``shape`` is given, any dim whose size does not divide over its mapped
    mesh axes is replicated instead (graceful GQA/odd-head degradation).
    Mesh axes absent from this mesh are dropped; mesh axes must not
    repeat within one spec, and later occurrences demote.
    """
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    out = []
    for i, name in enumerate(axes):
        phys = rules.get(name) if name is not None else None
        if phys is not None:
            flat = tuple(phys) if isinstance(phys, (tuple, list)) else (phys,)
            # drop axes absent from this mesh (e.g. 'pod' on one pod)
            flat = tuple(p for p in flat if p in sizes)
            if not flat or any(p in used for p in flat):
                phys = None
            elif shape is not None and shape[i] % _axis_size(sizes, flat):
                phys = None
            else:
                used.update(flat)
                phys = flat if len(flat) > 1 else flat[0]
        out.append(phys)
    return PartitionSpec(*out)


def placements(spec: tuple, mesh: DeviceMesh | AbstractMesh
               ) -> tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim d is on that mesh dim, else
    ``Replicate()``."""
    out: list[Placement] = []
    for name in mesh_shape(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""

    mesh: DeviceMesh | AbstractMesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple[Placement, ...]:
        return placements(self.spec, self.mesh)


def named_sharding(axes: tuple, *, shape: tuple | None = None,
                   ctx: MeshContext | None = None) -> NamedSharding:
    ctx = ctx or current()
    if ctx is None:
        raise RuntimeError("named_sharding requires an active use_mesh()")
    return NamedSharding(ctx.mesh, spec_for(axes, mesh=ctx.mesh,
                                            rules=ctx.rules, shape=shape))


def logical(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Constrain an activation's sharding by logical axes: under
    `use_mesh` a DTensor redistributed to `spec_for`'s placements (a
    plain tensor there raises: the sharded paths carry DTensors); outside
    it ``x`` as it is."""
    ctx = current()
    if ctx is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"logical{tuple(axes)} under a mesh needs a DTensor, "
                        f"got a plain {type(x).__name__}")
    want = placements(spec_for(axes, mesh=ctx.mesh, rules=ctx.rules,
                               shape=tuple(x.shape)), ctx.mesh)
    if _same_layout(x.placements, want, ctx.mesh):
        return x
    return x.redistribute(ctx.mesh, want)


def _same_layout(a: tuple, b: tuple, mesh: DeviceMesh) -> bool:
    """Whether placements ``a`` and ``b`` put the same values on every
    rank: equal on every mesh dim of more than one rank (on a dim of one
    rank ``Shard`` and ``Replicate`` are the same layout, and a
    redistribute between them moves nothing but costs a DTensor
    dispatch, and an autograd node, each time)."""
    return all(p == q or mesh.size(i) == 1
               for i, (p, q) in enumerate(zip(a, b)))


def _ctx(ctx: MeshContext | None) -> MeshContext:
    ctx = ctx or current()
    if ctx is None or not isinstance(ctx.mesh, DeviceMesh):
        raise RuntimeError("needs an active use_mesh() over a DeviceMesh")
    return ctx


def _contiguous_stride(shape: tuple) -> tuple:
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def distribute(x: torch.Tensor, axes: tuple, *,
               ctx: MeshContext | None = None) -> DTensor:
    """The full tensor ``x`` (the same on every rank, as SPMD code makes
    it) as a DTensor sharded by its logical ``axes`` (the reference's
    ``device_put`` with `named_sharding`): each rank keeps its own shard,
    cut from its own copy, with no communication.  A dim on several mesh
    dims is cut in mesh order, the first the major one, as DTensor cuts
    it."""
    ctx = _ctx(ctx)
    return place(x, ctx.mesh, placements(spec_for(
        axes, mesh=ctx.mesh, rules=ctx.rules, shape=tuple(x.shape)),
        ctx.mesh))


def place(x: torch.Tensor, mesh: DeviceMesh, pls: tuple) -> DTensor:
    """The full tensor ``x`` as a DTensor of placements ``pls`` on
    ``mesh``: each rank cuts its shard (`distribute`; a checkpoint's
    leaf laid out elastically on the current mesh).  A shard that is
    part of ``x``'s storage is copied out, so that the rank holds only
    its shard, not all of ``x``; a whole ``x`` (one rank) is kept."""
    piece = x
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            piece = torch.tensor_split(piece, mesh.size(i),
                                       dim=p.dim)[coord[i]]
    piece = piece.contiguous()
    if piece.untyped_storage().nbytes() > piece.numel() * \
            piece.element_size():
        piece = piece.clone()   # a view would hold all of x alive
    return DTensor.from_local(piece, mesh, pls,
                              run_check=False, shape=x.shape,
                              stride=_contiguous_stride(tuple(x.shape)))


def zeros(shape: tuple, axes: tuple, *, dtype: torch.dtype,
          device: torch.device, ctx: MeshContext | None = None) -> DTensor:
    """A DTensor of zeros of global ``shape`` laid out by logical
    ``axes``: each rank makes only its own shard."""
    ctx = _ctx(ctx)
    spec = spec_for(axes, mesh=ctx.mesh, rules=ctx.rules, shape=shape)
    pls = placements(spec, ctx.mesh)
    piece = list(shape)
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            piece[p.dim] //= ctx.mesh.size(i)
    return DTensor.from_local(
        torch.zeros(piece, dtype=dtype, device=device), ctx.mesh, pls,
        run_check=False, shape=torch.Size(shape),
        stride=_contiguous_stride(tuple(shape)))


def local(x: DTensor, axes: tuple, *,
          ctx: MeshContext | None = None) -> torch.Tensor:
    """This rank's shard of ``x`` laid out by logical ``axes``: ``x``
    redistributed to `spec_for`'s placements, then its local tensor (the
    inside of a ``shard_map`` with that in-spec)."""
    ctx = _ctx(ctx)
    return local_spec(x, spec_for(axes, mesh=ctx.mesh, rules=ctx.rules,
                                  shape=tuple(x.shape)), ctx=ctx)


def local_spec(x: DTensor, spec: tuple, *,
               ctx: MeshContext | None = None) -> torch.Tensor:
    """This rank's shard of ``x`` laid out by a `PartitionSpec`
    (`shard_of` after the redistribute)."""
    ctx = _ctx(ctx)
    want = placements(spec, ctx.mesh)
    if not _same_layout(x.placements, want, ctx.mesh):
        x = x.redistribute(ctx.mesh, want)
    return shard_of(x)


def _grad_on(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def shard_of(x: DTensor) -> torch.Tensor:
    """``x``'s local tensor, whose gradient is partial over every mesh dim
    of more than one rank that ``x`` is replicated on (the module's
    gradient convention); ``to_local()`` where no gradient flows."""
    if not _grad_on(x):
        return x.to_local()
    mesh = x.device_mesh
    grad = tuple(Partial() if p.is_replicate() and mesh.size(i) > 1 else p
                 for i, p in enumerate(x.placements))
    return x.to_local(grad_placements=grad)


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient times ``s``."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, s: float) -> torch.Tensor:
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g * ctx.s, None


def wrap(t: torch.Tensor, mesh: DeviceMesh, pls: tuple, shape: tuple
         ) -> DTensor:
    """The shard ``t`` as a DTensor of global ``shape`` with placements
    ``pls``; its gradient divided by the ranks of the mesh dims of more
    than one rank that it is replicated on (the module's gradient
    convention)."""
    if _grad_on(t):
        n = math.prod(mesh.size(i) for i, p in enumerate(pls)
                      if p.is_replicate() and mesh.size(i) > 1)
        if n > 1:
            t = _ScaleGrad.apply(t, 1.0 / n)
    return DTensor.from_local(t.contiguous(), mesh, tuple(pls),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(tuple(shape)))


def from_local(t: torch.Tensor, axes: tuple, shape: tuple, *,
               ctx: MeshContext | None = None) -> DTensor:
    """This rank's shard ``t`` of a global tensor of ``shape`` laid out
    by logical ``axes`` (a ``shard_map`` out-spec) as a DTensor."""
    ctx = _ctx(ctx)
    return from_local_spec(t, spec_for(axes, mesh=ctx.mesh, rules=ctx.rules,
                                       shape=tuple(shape)), shape, ctx=ctx)


def from_local_spec(t: torch.Tensor, spec: tuple, shape: tuple, *,
                    ctx: MeshContext | None = None) -> DTensor:
    """This rank's shard ``t`` of a global tensor of ``shape`` laid out
    by a `PartitionSpec`, as a DTensor (`wrap`)."""
    ctx = _ctx(ctx)
    return wrap(t, ctx.mesh, placements(spec, ctx.mesh), shape)


def _flat(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def axis_size(entry: Any, *, ctx: MeshContext | None = None) -> int:
    """Ranks along a spec entry (a mesh dim name, a tuple of them, or
    None): the product of their sizes."""
    return _axis_size(_ctx(ctx).shape, _flat(entry) or None)


def axis_index(entry: Any, *, ctx: MeshContext | None = None) -> int:
    """This rank's index along a spec entry, the first dim the major one
    (``lax.axis_index`` over those axes); 0 for None."""
    ctx = _ctx(ctx)
    idx = 0
    for name in _flat(entry):
        idx = idx * ctx.mesh.size(ctx.mesh.mesh_dim_names.index(name)) \
            + ctx.mesh.get_local_rank(name)
    return idx


def _groups(entry: Any, ctx: MeshContext) -> list:
    return [ctx.mesh.get_group(name) for name in _flat(entry)
            if ctx.mesh.size(ctx.mesh.mesh_dim_names.index(name)) > 1]


class _PSum(torch.autograd.Function):
    """``psum`` out of place, its gradient the ``psum`` of the incoming
    one (`all_reduce` under grad)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, groups: list) -> torch.Tensor:
        ctx.groups = groups
        out = t.clone(memory_format=torch.contiguous_format)
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone(memory_format=torch.contiguous_format)
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


def all_reduce(t: torch.Tensor, entry: Any, op: str = "sum", *,
               ctx: MeshContext | None = None) -> torch.Tensor:
    """``t`` reduced over the ranks along a spec entry (``psum`` / ``pmax``
    over those axes; nothing for None or a dim of one rank).  Without a
    gradient in place (``t`` itself comes back); under grad a sum is the
    autograd op `_PSum`, a new tensor, and a max raises (the models take
    it only outside the gradient)."""
    ctx = _ctx(ctx)
    groups = _groups(entry, ctx)
    if _grad_on(t):
        if op != "sum":
            raise ValueError(f"all_reduce({op!r}) has no gradient: detach "
                             f"its input")
        return _PSum.apply(t, groups) if groups else t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for g in groups:
        dist.all_reduce(t, op=red, group=g)
    return t


def sum_over(t: torch.Tensor, mesh: DeviceMesh, dims: Any) -> torch.Tensor:
    """``t`` summed in place, with no gradient, over the mesh dims
    ``dims`` (indices) of more than one rank: the optimizer's and the
    clip's reductions over the dims that shard a leaf."""
    for i in dims:
        if mesh.size(i) > 1:
            dist.all_reduce(t, group=mesh.get_group(i))
    return t


@contextlib.contextmanager
def mesh_ops() -> Iterator[None]:
    """Around a model entry: under a `DeviceMesh` context, plain tensors
    made inside (positions, masks, constants) meet DTensors as replicated
    ones (``implicit_replication``); otherwise nothing."""
    ctx = current()
    if ctx is None or not isinstance(ctx.mesh, DeviceMesh):
        yield
        return
    with implicit_replication():
        yield


def _is_axes(t: Any) -> bool:
    return isinstance(t, tuple)


def sharding_tree(axes_tree: Any, shape_tree: Any = None, *,
                  ctx: MeshContext | None = None) -> Any:
    """Tree of logical-axes tuples (+ optional matching shapes) ->
    NamedShardings, with the tree's nesting (dicts and lists)."""
    ctx = ctx or current()
    if ctx is None:
        raise RuntimeError("sharding_tree requires an active use_mesh()")

    def walk(a: Any, s: Any) -> Any:
        if _is_axes(a):
            return named_sharding(a, shape=s, ctx=ctx)
        if isinstance(a, list):
            return [walk(v, None if s is None else s[i])
                    for i, v in enumerate(a)]
        return {k: walk(v, None if s is None else s[k])
                for k, v in a.items()}

    return walk(axes_tree, shape_tree)
