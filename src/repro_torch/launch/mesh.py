"""Meshes over the ranks of a `torch.distributed` world.

The port of `repro/launch/mesh.py`.  One process per rank: every rank
runs the same program (SPMD) and holds its own shard of each sharded
tensor.  `init_process_group` starts the world (NCCL on CUDA, one card a
rank, ``cuda:LOCAL_RANK``; gloo on the CPU) through a ``file://`` store,
so no TCP port is taken; a CUDA world is NCCL or nothing, it never gives
way to gloo.  `make_local_mesh` lays the world out as a
``("data", "model")`` `DeviceMesh`; `make_production_mesh` gives the
reference's 16x16 (or 2x16x16) pod as a shape-only
`parallel.sharding.AbstractMesh`, which has no ranks.  For the dry run
only (`launch.dryrun`), `fake_world` stands this process as one rank of
a world of 256 or 512 that has no processes, with that pod's
`DeviceMesh`: collectives move nothing and return at once, so a rank's
step on ``meta`` can be counted (`utils.cost`).

Start a two-rank CPU world by hand, one process a rank::

    RANK=0 WORLD_SIZE=2 python my_script.py &
    RANK=1 WORLD_SIZE=2 python my_script.py

with ``init_process_group("/tmp/store", device="cpu")`` then
``make_local_mesh(data=1, model=2)`` in ``my_script.py``; on a machine
with N cards the same with ``LOCAL_RANK`` set and ``device="cuda"``.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.device import resolve_device
from repro_torch.parallel.sharding import AbstractMesh, mesh_shape

__all__ = ["init_process_group", "make_production_mesh", "make_local_mesh",
           "make_model_mesh", "mesh_name", "mesh_axes", "fake_world",
           "POD", "MULTI_POD"]

POD = "16x16"           # one pod: ("data", "model")
MULTI_POD = "2x16x16"   # two pods: ("pod", "data", "model")


def init_process_group(store_path: str, *, rank: int | None = None,
                       world_size: int | None = None,
                       device: str | torch.device | None = None
                       ) -> torch.device:
    """Join (or start) the world through the ``file://`` store at
    ``store_path`` and return this rank's device.

    ``rank`` and ``world_size`` default to the ``RANK`` and
    ``WORLD_SIZE`` environment variables (0 and 1 without them).  On
    CUDA (the default) the backend is NCCL and the rank's device is
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaulting to the rank), set as
    the current device; on the CPU it is gloo.  The store file must not
    be left over from another world.
    """
    dev = resolve_device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    kw = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
        kw["device_id"] = dev
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group for device {dev}")
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world_size, **kw)
    return dev


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 chips a pod; 2 pods = 512 with a leading 'pod' axis.
    Shape only (`AbstractMesh`): what `spec_for` and the dry run read."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def mesh_axes(name: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """A mesh's sizes and dim names from its name: ``"DxM"`` is
    ``("data", "model")``, ``"PxDxM"`` ``("pod", "data", "model")``
    (`POD`, `MULTI_POD`, or a small one such as ``"2x2"``)."""
    sizes = tuple(int(v) for v in name.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(sizes))
    if names is None or min(sizes) < 1:
        raise ValueError(f"mesh {name!r}: want DxM or PxDxM")
    return sizes, names


@contextlib.contextmanager
def fake_world(name: str, rank: int = 0) -> Iterator[DeviceMesh]:
    """Stand as rank ``rank`` of a world of as many ranks as the mesh
    ``name`` (`mesh_axes`) has, with no other process: a ``"fake"``
    process group (torch's testing backend: every collective returns at
    once and moves nothing) and the mesh over it, yielded.  The mesh's
    device type is ``cuda`` with or without a card, so that DTensor
    takes the collectives an NCCL mesh runs (on a ``cpu`` mesh it
    stands an all-gather and a chunk in for each all-to-all).  For the
    dry run only: the values of every collective are garbage.  The group
    is destroyed on exit, and DTensor's caches are cleared on entry and
    exit (`_forget_meshes`); raises where a world is already up."""
    # torch's one fake process group; importing it registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    sizes, names = mesh_axes(name)
    world = math.prod(sizes)
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already up")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    _forget_meshes()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield init_device_mesh("cuda", sizes, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()
        _forget_meshes()


def _forget_meshes() -> None:
    """Clear DTensor's caches of sharding decisions.  They are keyed by
    mesh, and a mesh compares equal to one of an earlier world of the
    same shape and device type whatever this process's rank: without
    this a later world would be handed the earlier world's mesh, whose
    groups are gone.  Each cache is cleared where this torch has it."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    for cache in (getattr(prop, "propagate_op_sharding", None),
                  getattr(_redistribute, "_gen_transform_infos", None)):
        if hasattr(cache, "cache_clear"):
            cache.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()


def make_local_mesh(data: int | None = None, model: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the whole world (``data``
    defaults to world // model)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = data or n // model
    if data * model != n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks, "
                         f"the world has {n}")
    return init_device_mesh(_device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


def make_model_mesh() -> DeviceMesh:
    """A ``("model",)`` mesh over the whole world: one CNN replica whose
    FC heads are cout-sharded over every rank (`launch.serve.ReplicaGroup`
    with ``shard_fc``)."""
    return init_device_mesh(_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=("model",))


def mesh_name(mesh: DeviceMesh | AbstractMesh) -> str:
    return "x".join(f"{k}{v}" for k, v in mesh_shape(mesh).items())
