"""The cost of one eager step, counted op by op as it runs.

The port's counterpart of `repro/utils/hlo.py`, which reads the cost of
a step out of its compiled XLA text.  The port has no XLA program: it
runs the step itself, eagerly, under `CostCounter`, a
`TorchDispatchMode` that sees every op the dispatcher runs (the
backward's too) and each hand-written kernel as one op (the kernels are
``torch.library.custom_op``s, `kernels.flash`, `kernels.vsmm`).  On the
``meta`` device the step allocates nothing and launches nothing, so the
count of a pod-sized step takes host time only; on the card the same
counter counts the real step, and the two must agree (``chip_smoke.py``'s
``dryrun`` phase).  The conventions follow `hlo.py`'s:

- FLOPs.  ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and ``convolution``
  (and their backward) count 2 x result x contraction (`hlo.py:217-245`),
  by `torch.utils.flop_counter`'s formulas.  A floating-point ``mul``
  counts 2 an output element (`hlo.py:394-408`), and so does a square
  (``pow`` by 2, which XLA lowers to a multiply); every other elementwise
  op 0.  A kernel counts its cost function's FLOPs
  (`register_kernel_cost`).  A stated difference: on a TPU the reference
  counts a Pallas custom call at 0 FLOPs (`hlo.py:409-414`).
- Bytes.  In eager mode every op is its own kernel, so an op counts the
  bytes of its tensor inputs and outputs on the counted device: `hlo.py`'s
  fusion-boundary rule with one op a fusion.  Views count 0, and so do
  ops that only allocate (``empty``).  An in-place write that reads
  nothing of its destination (``copy_``, ``fill_``, ``zero_``) counts its
  sources and the destination once.  A gather (``index``,
  ``index_select``, ``embedding``, ``gather``) counts 2 x its result,
  and an in-place scatter (``index_copy_``, ``index_put_``, ``scatter_``,
  ``index_add_``) 2 x its update, as `hlo.py` counts a gather and a
  dynamic-update-slice.  A kernel counts its cost function's bytes.
- Loops.  A loop body is counted once and scaled by its trip count
  (`repeat`), as `hlo.py:282-296` scales a while body.  The recurrent
  mixers' loops over T are `scan`s: the card runs every trip; on meta
  one trip stands for all of them, and under autograd one stands for
  all but the first and the last two, its backward scaled alike (so the
  sums of gradients across trips are counted too), with the same count.
- Collectives.  Each collective counts its wire bytes by `hlo.py`'s
  ring factors (`hlo.py:342-364`), over its group of n ranks:
  all-reduce 2 x size x (n-1)/n, all-gather result x (n-1)/n,
  reduce-scatter operand x (n-1)/n, all-to-all size x (n-1)/n, a
  broadcast its size; and 2 x its result of HBM bytes.  Caught are
  `torch.distributed`'s functional ops (``_c10d_functional``: DTensor's
  redistributes), its in-place ops (``c10d``: ``dist.all_reduce`` and
  friends, whose group is a ``ProcessGroup`` argument) and DTensor's
  ``_dtensor.shard_dim_alltoall``; ``wait_tensor`` and
  ``_wrap_tensor_autograd`` count nothing.  ``coll_by_kind`` sums the
  wire bytes by kind (`hlo.py`'s names), ``coll_by_dim`` by the mesh dim
  whose group ran them (the ``mesh`` given, else the active one's),
  ``coll_ops`` keeps each (kind, wire bytes, shape) for
  `collective_report`.  What is counted is what an NCCL mesh runs: on a
  mesh whose device type is ``cpu`` DTensor stands an all-gather and a
  chunk in for each all-to-all (gloo has none), so the dry run builds
  its meshes with the device type ``cuda``, on which DTensor takes the
  NCCL path with no card present (`launch.mesh.fake_world`).
- DTensors.  An op on DTensors is passed on to DTensor (the counter
  returns ``NotImplemented``), so that what is counted is what each rank
  runs: the ops on its local shards and the collectives of the
  redistributes.  The ops that DTensor's sharding propagation runs on
  fake tensors are not work and count nothing.
- Memory.  Every allocation is keyed on its storage (a
  `StorageWeakRef`, which follows the storage and not the Python
  wrapper), so `StepCost` gives ``arg_bytes`` (the step's arguments:
  parameters, optimizer state, batch, caches; of a DTensor its local
  shard) and the peak of live bytes,
  and ``temp_bytes`` the peak less the arguments: XLA's
  ``memory_analysis()`` figures.  A kernel's workspace (its cost
  function's scratch) is live for its launch; what a scan's standing-in
  trip leaves alive (its output, what autograd saved) counts once for
  each trip it stands for.  Storages allocated below
  the dispatcher (a library's own workspace) are not seen, on either
  device.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed import ProcessGroup
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import flop_registry

__all__ = ["StepCost", "CostCounter", "count", "repeat", "scan",
           "uncounted", "register_kernel_cost", "KERNEL_COSTS",
           "collective_report", "wire_bytes"]

# op -> (kernel name, cost(*args, **kwargs) -> (flops, bytes, scratch))
KERNEL_COSTS: dict[Any, tuple[str, Callable[..., tuple[int, int, int]]]] = {}

_REPEAT = contextvars.ContextVar("repro_torch_cost_repeat", default=1)
_COUNTER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cost_counter", default=None)

_aten = torch.ops.aten
_MUL = {_aten.mul, _aten.mul_}
_SQUARE = {_aten.pow.Tensor_Scalar, _aten.pow_.Scalar}
_ALLOCATE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided, _aten.resize_,
             _aten.set_}
_VIEW_LIKE = {_aten._unsafe_view, _aten.lift_fresh, _aten.alias}
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_}
_GATHER = {_aten.index, _aten.index_select, _aten.embedding, _aten.gather}
_SCATTER = {_aten.index_copy_, _aten.index_put_, _aten._index_put_impl_,
            _aten.scatter_, _aten.index_add_, _aten.scatter_add_}
_NOT_WORK = {_aten.record_stream}

# collectives by schema name: (kind, the argument holding the result
# (None: the op's return), the argument holding the operand)
_COLLECTIVES = {
    "_c10d_functional::all_reduce": ("all-reduce", None, "input"),
    "_c10d_functional::all_reduce_": ("all-reduce", None, "input"),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", None,
                                               "inputs"),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", None,
                                                 "input"),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", None,
                                                     "input"),
    "_c10d_functional::all_gather_into_tensor_coalesced": (
        "all-gather", None, "inputs"),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", None,
                                                "input"),
    "_c10d_functional::reduce_scatter_tensor_coalesced": (
        "reduce-scatter", None, "inputs"),
    "_c10d_functional::all_to_all_single": ("all-to-all", None, "input"),
    "_c10d_functional::broadcast": ("collective-broadcast", None, "input"),
    "_dtensor::shard_dim_alltoall": ("all-to-all", None, "input"),
    "c10d::allreduce_": ("all-reduce", "tensors", "tensors"),
    "c10d::allreduce_coalesced_": ("all-reduce", "tensors", "tensors"),
    "c10d::allgather_": ("all-gather", "output_tensors", "input_tensors"),
    "c10d::_allgather_base_": ("all-gather", "output_tensor",
                               "input_tensor"),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", "outputs",
                                               "inputs"),
    "c10d::reduce_scatter_": ("reduce-scatter", "output_tensors",
                              "input_tensors"),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", "output_tensor",
                                    "input_tensor"),
    "c10d::alltoall_base_": ("all-to-all", "output", "input"),
    "c10d::alltoall_": ("all-to-all", "output_tensors", "input_tensors"),
    "c10d::broadcast_": ("collective-broadcast", "tensors", "tensors"),
}
# no work: waits, autograd wrappers, a barrier
_NO_COST = {"_c10d_functional::wait_tensor",
            "_c10d_functional::_wrap_tensor_autograd", "c10d::barrier"}


def wire_bytes(kind: str, n: int, size: float, operand: float) -> float:
    """The bytes each rank sends for one collective over ``n`` ranks
    (`hlo.py:342-364`'s ring factors): ``size`` its result's bytes,
    ``operand`` its operand's."""
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return operand * (n - 1) / max(n, 1)
    if kind in ("all-gather", "all-to-all"):
        return size * (n - 1) / max(n, 1)
    return size   # permute / broadcast


def _group(value: Any) -> Any:
    """The process group of a collective's group argument: a
    ``ProcessGroup``, or the name of one."""
    if isinstance(value, str):
        from torch._C._distributed_c10d import _resolve_process_group
        return _resolve_process_group(value)
    if isinstance(value, torch.ScriptObject):   # a ``c10d`` op's argument
        return ProcessGroup.unbox(value)
    return value


def register_kernel_cost(op: Any, name: str,
                         cost: Callable[..., tuple[int, int, int]]) -> None:
    """Count ``op`` (a kernel's custom op overload) as one launch of
    kernel ``name``: ``cost(*args, **kwargs)`` gives its (FLOPs, bytes,
    scratch bytes live for the launch)."""
    KERNEL_COSTS[op] = (name, cost)


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Run the block outside any counter: ops that build only shapes
    (templates on meta that a step reads the sizes of), which the card
    does not run as work.  Without a counter it changes nothing."""
    with _disable_current_modes():
        yield


@contextlib.contextmanager
def repeat(n: int) -> Iterator[None]:
    """Count every op in the block ``n`` times: a loop body run once
    that stands for ``n`` identical trips.  Scopes nest (they multiply);
    allocations are counted once."""
    token = _REPEAT.set(_REPEAT.get() * n)
    try:
        yield
    finally:
        _REPEAT.reset(token)


def scan(step: Callable[[Any, int], tuple[Any, torch.Tensor]], carry: Any,
         t: int, x: torch.Tensor) -> tuple[Any, list[torch.Tensor]]:
    """``carry, y_i = step(carry, i)`` for i in [0, t): the last carry and
    the t outputs.  ``x`` is the loop's input (its device and whether a
    gradient flows through it decide the form).

    On the card and the CPU every trip runs.  On meta the trips are
    identical, so fewer run, and the count is the loop's.  Outside
    autograd one trip runs, under ``repeat(t)``.  Under autograd four
    do: the first, one that stands for trips 1 to t - 3 (under
    ``repeat(t - 3)``, its backward scaled alike), and the last two.
    Only the first takes a carry that needs no gradient, and only the
    last sends its successor none (its carry is the loop's output), so
    the standing-in trip's backward, the sums of the gradients that its
    successor and its shared inputs receive included, is that of each
    trip it stands for.  The outputs are the trips' repeated to t (the
    repeats detached, so no extra sum reaches a backward); what the
    standing-in trip leaves alive, but the last carry, counts for each
    trip it stands for.  Without a counter only the shapes matter."""
    grad = torch.is_grad_enabled() and x.requires_grad
    head, tail = (1, 2) if grad else (0, 0)
    stands = t - head - tail
    if x.device.type != "meta" or stands < 2:
        ys = []
        for i in range(t):
            carry, y = step(carry, i)
            ys.append(y)
        return carry, ys
    first = []
    for i in range(head):
        carry, y = step(carry, i)
        first.append(y)
    counter = _COUNTER.get()
    region = counter.open_region() if counter is not None else None
    lo = torch._C._autograd._get_sequence_nr()
    try:   # (a checkpoint's recompute may stop inside the trip)
        with repeat(stands):
            carry, y = step(carry, head)
    finally:
        if counter is not None:
            counter.close_region(region)
    if counter is not None and grad:
        counter.scale_backward(
            lo, torch._C._autograd._get_sequence_nr(), stands)
    last = []
    for i in range(t - tail, t):
        carry, y_i = step(carry, i)
        last.append(y_i)
    if grad:
        with _disable_current_modes():
            ys = first + [y] + [y.detach() for _ in range(stands - 1)] + last
    else:
        ys = [y] * t
    if counter is not None:
        counter.retain(region, stands, exclude=_tensors(carry))
    return carry, ys


@dataclasses.dataclass
class StepCost:
    """One step's count.  ``ops``: {op: [calls, flops, bytes]};
    ``kernels``: {kernel: launches}; bytes of memory on the counted
    device.  Wire bytes: ``coll_bytes`` in all, ``coll_by_kind`` {kind:
    bytes}, ``coll_by_dim`` {mesh dim: bytes} (``"?"`` for a group of no
    mesh dim), ``coll_ops`` [(kind, bytes, shape)]."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_by_dim: dict = dataclasses.field(default_factory=dict)
    coll_ops: list = dataclasses.field(default_factory=list)
    ops: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    arg_bytes: int = 0
    peak_bytes: int = 0

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.arg_bytes

    # the names of XLA's memory_analysis(), which `roofline.report` reads
    @property
    def argument_size_in_bytes(self) -> int:
        return self.arg_bytes

    @property
    def temp_size_in_bytes(self) -> int:
        return self.temp_bytes


def _tensors(tree: Any, out: list | None = None) -> list[torch.Tensor]:
    """The tensors of a tree of lists, tuples and dicts, in order (of a
    DTensor its local shard)."""
    out = [] if out is None else out
    if isinstance(tree, DTensor):
        out.append(tree.to_local())
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class CostCounter(TorchDispatchMode):
    """Count every op run inside ``with CostCounter(args):`` into
    ``self.cost`` (`StepCost`).  ``args``: the step's arguments (any tree
    of tensors), whose storages make ``arg_bytes``; ``device``: the
    device whose bytes count (default: that of the first argument
    tensor); ``mesh``: the `DeviceMesh` whose dims ``coll_by_dim`` names
    (default: the active `parallel.sharding.use_mesh`'s, if any)."""

    def __init__(self, args: Any = (), device: str | torch.device |
                 None = None, mesh: Any = None) -> None:
        super().__init__()
        flat = _tensors(args)
        if device is None:
            device = flat[0].device if flat else "meta"
        self.device_type = torch.device(device).type
        self._dims = _mesh_groups(mesh)
        self.cost = StepCost()
        self._live: dict[int, tuple[StorageWeakRef, int]] = {}
        self._cur = 0
        self._regions: list[set] = []   # open `scan` regions' allocations
        self._backward: list[tuple[int, int, int]] = []   # (lo, hi, scale)
        self._token: Any = None
        for t in flat:
            self._allocated(t)
        self.cost.arg_bytes = self.cost.peak_bytes = self._cur

    def __enter__(self) -> "CostCounter":
        self._token = _COUNTER.set(self)
        return super().__enter__()

    def __exit__(self, *exc: Any) -> None:
        super().__exit__(*exc)
        _COUNTER.reset(self._token)

    # -- scans -------------------------------------------------------------
    def open_region(self) -> set:
        """Start recording the storages allocated (a `scan` trip)."""
        region: set = set()
        self._regions.append(region)
        return region

    def close_region(self, region: set) -> None:
        self._regions.remove(region)

    def retain(self, region: set, n: int, exclude: list) -> None:
        """Count each storage of ``region`` still alive, but those of the
        ``exclude`` tensors, ``n`` times from now on."""
        keep = {StorageWeakRef(t.untyped_storage()).cdata for t in exclude
                if t.device.type == self.device_type}
        for key in region - keep:
            held = self._live.get(key)
            if held is not None and not held[0].expired():
                self._live[key] = (held[0], held[1] * n)
                self._cur += held[1] * (n - 1)
        if self._cur > self.cost.peak_bytes:
            self._sweep()
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._cur)

    def scale_backward(self, lo: int, hi: int, n: int) -> None:
        """Count the backward of autograd nodes [lo, hi) (by sequence
        number) ``n`` times."""
        self._backward.append((lo, hi, n))

    def _scale(self) -> int:
        scale = _REPEAT.get()
        if self._backward:
            node = torch._C._current_autograd_node()
            if node is not None:
                seq = node._sequence_nr()
                for lo, hi, n in self._backward:
                    if lo <= seq < hi:
                        scale *= n
        return scale

    # -- memory ------------------------------------------------------------
    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._cur -= self._live.pop(k)[1]

    def _allocated(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        storage = t.untyped_storage()
        ref = StorageWeakRef(storage)
        held = self._live.get(ref.cdata)
        if held is not None:
            if not held[0].expired():
                return  # a view, or an in-place result
            self._cur -= held[1]
        n = storage.nbytes()
        self._live[ref.cdata] = (ref, n)
        self._cur += n
        for region in self._regions:
            region.add(ref.cdata)
        if self._cur > self.cost.peak_bytes:
            self._sweep()
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._cur)

    def _scratch(self, n: int) -> None:
        if self._cur + n > self.cost.peak_bytes:
            self._sweep()
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._cur + n)

    # -- counting ----------------------------------------------------------
    def _nbytes(self, t: Any) -> int:
        if isinstance(t, torch.Tensor) and t.device.type == self.device_type:
            return t.numel() * t.element_size()
        return 0

    def _op_cost(self, func: Any, args: tuple, kwargs: dict,
                 out: Any) -> tuple[float, float]:
        packet = func.overloadpacket
        flops = 0.0
        formula = flop_registry.get(packet)
        if formula is not None:  # (an ``out_dtype`` overload's dtype off)
            shapes = [a for a in args if not isinstance(a, torch.dtype)]
            flops = float(formula(*shapes, **kwargs, out_val=out))
        elif (packet in _MUL or func in _SQUARE and args[1] == 2) and \
                isinstance(out, torch.Tensor) and out.is_floating_point():
            flops = 2.0 * out.numel()  # x ** 2 is x * x, as XLA lowers it
        if func.is_view or packet in _VIEW_LIKE or packet in _ALLOCATE:
            return flops, 0.0
        outs = _tensors(out)
        if packet in _GATHER:
            return flops, 2.0 * sum(map(self._nbytes, outs))
        ins = _tensors((args, kwargs))
        if packet in _SCATTER:
            update = [t for t in ins[1:] if t.is_floating_point()]
            return flops, 2.0 * sum(map(self._nbytes, update))
        if packet in _WRITE_ONLY:
            ins = ins[1:]
        return flops, float(sum(map(self._nbytes, ins)) +
                            sum(map(self._nbytes, outs)))

    def _collective(self, func: Any, kind: str, result: str | None,
                    operand: str, args: tuple, kwargs: dict, out: Any,
                    scale: int) -> None:
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        group = _group(named.get("group_name", named.get("process_group")))
        n = group.size()
        size = sum(map(self._nbytes, _tensors(
            out if result is None else named[result])))
        wire = scale * wire_bytes(kind, n, size, sum(map(
            self._nbytes, _tensors(named[operand]))))
        dim = self._dims.get(group.group_name, "?")
        c = self.cost
        c.coll_bytes += wire
        c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + wire
        c.coll_by_dim[dim] = c.coll_by_dim.get(dim, 0.0) + wire
        shapes = [tuple(t.shape) for t in _tensors(named[operand])][:2]
        c.coll_ops.append((kind, wire, f"{dim} x{n} {shapes}"))
        nbytes = scale * 2.0 * size
        c.bytes += nbytes
        tally = c.ops.setdefault(str(func), [0, 0.0, 0.0])
        tally[0] += scale
        tally[2] += nbytes

    def __torch_dispatch__(self, func: Any, types: Any, args: tuple = (),
                           kwargs: dict | None = None) -> Any:
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # counted as the local ops it runs
        out = func(*args, **kwargs)
        if func.overloadpacket in _NOT_WORK or _fake(args, kwargs, out):
            return out
        name = func._schema.name
        if name in _NO_COST:
            return out
        for t in _tensors(out):
            self._allocated(t)
        scale = self._scale()
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            self._collective(func, *coll, args, kwargs, out, scale)
            return out
        kernel = KERNEL_COSTS.get(func)
        if kernel is not None:  # its workspace lives beside its output
            name, cost = kernel
            flops, nbytes, scratch = cost(*args, **kwargs)
            self.cost.kernels[name] = self.cost.kernels.get(name, 0) + scale
            if scratch:
                self._scratch(scratch)
        else:
            flops, nbytes = self._op_cost(func, args, kwargs, out)
        flops, nbytes = flops * scale, nbytes * scale
        self.cost.flops += flops
        self.cost.bytes += nbytes
        tally = self.cost.ops.setdefault(str(func), [0, 0.0, 0.0])
        tally[0] += scale
        tally[1] += flops
        tally[2] += nbytes
        return out


def _fake(args: tuple, kwargs: dict, out: Any) -> bool:
    """Whether an op ran on fake tensors (DTensor's sharding
    propagation): shapes only, no work of the step."""
    return any(isinstance(t, FakeTensor)
               for t in _tensors((args, kwargs, out)))


def _mesh_groups(mesh: Any) -> dict[str, str]:
    """{process group name: mesh dim name} of a `DeviceMesh` (``mesh``,
    else the active mesh's); {} without one."""
    if mesh is None:
        from repro_torch.parallel import sharding as shd
        ctx = shd.current()
        mesh = None if ctx is None else ctx.mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        return {}
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(names)}


def collective_report(cost: StepCost, top: int = 12) -> str:
    """The wire bytes by kind and the largest collectives
    (`hlo.collective_report`)."""
    lines = [f"collective wire bytes/device: {cost.coll_bytes / 1e9:.3f} GB"]
    for k, v in sorted(cost.coll_by_kind.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {k:24s} {v / 1e9:9.3f} GB")
    for kind, b, shape in sorted(cost.coll_ops, key=lambda t: -t[1])[:top]:
        lines.append(f"    {kind:22s} {b / 1e6:10.1f} MB  {shape}")
    return "\n".join(lines)


def count(fn: Callable[..., Any], *args: Any, **kwargs: Any
          ) -> tuple[Any, StepCost]:
    """``fn(*args, **kwargs)`` run under a `CostCounter` over ``args``:
    (its result, its `StepCost`)."""
    with CostCounter(args) as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost
