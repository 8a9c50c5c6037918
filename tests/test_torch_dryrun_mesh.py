"""The dry run of the production mesh (`launch.dryrun` with a mesh): one
rank's step counted on meta in a fake world (`launch.mesh.fake_world`),
its collectives (`utils.cost`) and their link term (`utils.roofline`).

- Against the reference.  One subprocess (`_torch_dryrun_mesh_ref`)
  compiles the reference's sharded step of reduced configs on **Auto**
  meshes of four host devices; the port counts rank 0 of the same mesh
  on meta.  Cases: Qwen1.5-4B train on 2x2 and 4x1, Qwen decode on 2x2
  (``kv_seq`` sharded), Granite-MoE train on 2x2 (the MoE's dispatch),
  Qwen train on a ``("pod", "data", "model")`` 2x1x2 mesh (the batch on
  the tuple ``("pod", "data")``).  Per device: FLOPs within 5%, argument
  bytes within 5%, total wire bytes within 25% (both sides'
  ``coll_by_kind`` in the message).  The three train cases whose wire
  bytes miss are strict xfails with the measured ratio: the reference's
  XLA all-reduces the weight gradients whole where the port
  reduce-scatters them (ROADMAP queue 3).
- Each collective kind on a fake world of 4 counts `hlo.py`'s ring
  formula exactly, through ``_c10d_functional`` and ``c10d`` alike, and
  DTensor's all-to-all counts as an all-to-all (on a ``cpu`` mesh it
  would be an all-gather and a chunk: the trap the ``cuda`` mesh
  avoids).
- The ``sp`` flash kernel's count depends on the rank: rank 0 and the
  last rank of a reduced Qwen prefill.
- A 1x1 mesh moves no wire byte; a registered arch's cell on the full
  16x16 fake world runs to a row with ``chips`` 256 and ``fits``; the
  skip rows carry the reference's ``pod16x16`` / ``pod2x16x16``.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard

import _torch_dryrun_mesh_ref as REF
from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_world
from repro_torch.utils.cost import CostCounter, wire_bytes

FLOP_RTOL = 0.05
ARG_RTOL = 0.05
WIRE_RTOL = 0.25
TRAIN = {"microbatches": 1}   # the dry run's baseline

CASES = {
    "qwen-train-2x2": REF.job("qwen1.5-4b", "train", (2, 2),
                              overrides=TRAIN),
    "qwen-train-4x1": REF.job("qwen1.5-4b", "train", (4, 1),
                              overrides=TRAIN),
    "qwen-decode-2x2": REF.job("qwen1.5-4b", "decode", (2, 2)),
    "granite-train-2x2": REF.job("granite-moe-3b-a800m", "train", (2, 2),
                                 overrides=TRAIN),
    "qwen-train-2x1x2": REF.job("qwen1.5-4b", "train", (2, 1, 2),
                                overrides=TRAIN),
    # heads that do not divide the model dim under ``sp``: each rank
    # projects its block of the sequence only
    "qwen-train-1x4-6heads": REF.job(
        "qwen1.5-4b", "train", (1, 4),
        overrides=dict(TRAIN, n_heads=6, n_kv_heads=2, d_model=192)),
}
# port / reference wire bytes measured on this tree where they miss
WIRE_GAPS = {"qwen-train-2x2": 0.58, "granite-train-2x2": 0.70,
             "qwen-train-2x1x2": 0.70}


def _port(j: dict):
    cfg = dataclasses.replace(get_config(j["arch"]).reduce(),
                              **j["overrides"])
    shape = ShapeSpec("custom", j["seq"], j["batch"], j["kind"])
    mesh = "x".join(map(str, j["mesh"]))
    return D.count_step(cfg, shape, torch.device("meta"), mesh)[0]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    proc = REF.start(list(CASES.values()), tmp)
    try:
        port = {name: _port(j) for name, j in CASES.items()}
    finally:
        ref = REF.result(proc, tmp)
    return port, dict(zip(CASES, ref))


@pytest.mark.parametrize("case", list(CASES))
def test_flops_and_argument_bytes_per_device(both, case):
    port, ref = both[0][case], both[1][case]
    ratio = port.flops / ref["flops"]
    assert abs(ratio - 1) <= FLOP_RTOL, (
        f"{case}: FLOPs port {port.flops:.6g} / reference "
        f"{ref['flops']:.6g} = {ratio:.4f}")
    ratio = port.arg_bytes / ref["arg_bytes"]
    assert abs(ratio - 1) <= ARG_RTOL, (
        f"{case}: argument bytes port {port.arg_bytes} / reference "
        f"{ref['arg_bytes']} = {ratio:.4f}")


def _wire_params():
    out = []
    for name in CASES:
        marks = ()
        if name in WIRE_GAPS:
            marks = pytest.mark.xfail(strict=True, reason=(
                f"port / reference wire bytes {WIRE_GAPS[name]}: the "
                f"reference's XLA all-reduces the weight gradients whole "
                f"where the port reduce-scatters them (ROADMAP queue 3)"))
        out.append(pytest.param(name, marks=marks))
    return out


@pytest.mark.parametrize("case", _wire_params())
def test_wire_bytes_per_device(both, case):
    port, ref = both[0][case], both[1][case]
    ratio = port.coll_bytes / ref["coll_bytes"]
    assert abs(ratio - 1) <= WIRE_RTOL, (
        f"{case}: wire bytes port {port.coll_bytes:.6g} / reference "
        f"{ref['coll_bytes']:.6g} = {ratio:.3f}; port by kind "
        f"{port.coll_by_kind}, reference by kind {ref['coll_by_kind']}")
    assert port.coll_by_dim and sum(port.coll_by_dim.values()) == \
        pytest.approx(port.coll_bytes)


def _local(n: int) -> torch.Tensor:
    return torch.empty(n, 8, device="meta")


def _run(kind: str, mesh) -> None:
    """One collective of ``kind`` over ``mesh``'s ``model`` dim (4
    ranks): through the functional ops, as DTensor issues them, and
    through `torch.distributed`'s in-place ops, as the port's `_PSum`
    and compression do."""
    t, group = _local(16), mesh.get_group("model")
    pg = (mesh, 1)
    if kind == "all-reduce":
        funcol.all_reduce(t, "sum", pg)
        dist.all_reduce(t, group=group)
    elif kind == "all-gather":
        funcol.all_gather_tensor(t, 0, pg)
        dist.all_gather([torch.empty_like(t) for _ in range(4)], t,
                        group=group)
    elif kind == "reduce-scatter":
        funcol.reduce_scatter_tensor(t, "sum", 0, pg)
        dist.reduce_scatter_tensor(_local(4), t, group=group)
    elif kind == "all-to-all":
        funcol.all_to_all_single(t, None, None, pg)
        dist.all_to_all_single(torch.empty_like(t), t, group=group)
    else:
        funcol.broadcast(t, 0, pg)
        dist.broadcast(t, group=group, group_src=0)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-broadcast"])
def test_each_collective_counts_the_ring_formula(kind):
    size = 16 * 8 * 4                       # the operand's bytes
    result = {"all-gather": 4 * size, "reduce-scatter": size // 4}.get(
        kind, size)
    with fake_world("1x4") as mesh:
        with CostCounter(device="meta", mesh=mesh) as counter:
            _run(kind, mesh)
    cost = counter.cost
    one = wire_bytes(kind, 4, result, size)
    assert one == {"all-reduce": 2 * size * 3 / 4,
                   "all-gather": 4 * size * 3 / 4,
                   "reduce-scatter": size * 3 / 4,
                   "all-to-all": size * 3 / 4,
                   "collective-broadcast": size}[kind]
    assert cost.coll_by_kind == {kind: 2 * one}   # both routes
    assert cost.coll_by_dim == {"model": 2 * one}
    assert cost.coll_bytes == 2 * one and len(cost.coll_ops) == 2
    assert cost.bytes == 2 * 2 * result          # 2 x the result each
    assert not dist.is_initialized()


def test_dtensor_all_to_all_is_an_all_to_all():
    """Shard(0) -> Shard(1) over 4 ranks is one all-to-all of the shard:
    on the dry run's ``cuda`` mesh DTensor runs it, on a ``cpu`` mesh it
    would gather the whole tensor and keep a chunk."""
    local = torch.empty(8, 16, device="meta")
    counts = {}
    with fake_world("1x4") as mesh:
        cpu = init_device_mesh("cpu", (1, 4),
                               mesh_dim_names=mesh.mesh_dim_names)
        for name, m in (("cuda", mesh), ("cpu", cpu)):
            x = DTensor.from_local(local, m, (Shard(0), Shard(0)),
                                   run_check=False)
            with CostCounter(device="meta", mesh=m) as counter:
                x.redistribute(m, (Shard(0), Shard(1)))
            counts[name] = counter.cost.coll_by_kind
    size = 8 * 16 * 4
    assert counts["cuda"] == {"all-to-all": size * 3 / 4}
    assert counts["cpu"] == {"all-gather": 4 * size * 3 / 4}


def test_sp_flash_count_depends_on_the_rank():
    """Qwen's ``sp`` prefill on 2x2: each rank's queries are its block of
    the sequence at ``q_offset``, so the causal kernel's work grows with
    the rank's block; the two model ranks' kernel FLOPs sum to those of
    the same rows on one card, and every other op is the same."""
    cfg = get_config("qwen1.5-4b").reduce()
    assert cfg.attn_sharding == "sp"
    shape = ShapeSpec("custom", 32, 4, "prefill")
    flash = "repro_torch.flash_fwd.default"
    meta = torch.device("meta")
    first = D.count_step(cfg, shape, meta, "2x2", rank=0)[0]
    last = D.count_step(cfg, shape, meta, "2x2", rank=3)[0]
    whole = D.count_step(cfg, ShapeSpec("custom", 32, 2, "prefill"), meta)[0]
    assert last.ops[flash][1] > first.ops[flash][1] > 0
    assert first.ops[flash][1] + last.ops[flash][1] == whole.ops[flash][1]
    assert first.kernels == last.kernels
    rest = {k: v for k, v in first.ops.items() if k != flash}
    assert rest == {k: v for k, v in last.ops.items() if k != flash}
    row = D.run_cell("qwen1.5-4b", "prefill_32k", cfg=cfg, shape=shape,
                     mesh="2x2", rank=3, verbose=False)
    assert row["rank"] == 3 and row["device_flops"] == last.flops


def test_one_rank_mesh_moves_no_wire_byte():
    cfg = get_config("qwen1.5-4b").reduce()
    for kind in ("train", "decode", "prefill"):
        row = D.run_cell("qwen1.5-4b", {"train": "train_4k",
                                        "decode": "decode_32k",
                                        "prefill": "prefill_32k"}[kind],
                         cfg=cfg, shape=ShapeSpec("c", 16, 2, kind),
                         overrides=TRAIN if kind == "train" else None,
                         mesh="1x1", verbose=False)
        assert row["chips"] == 1 and row["mesh"] == "data1xmodel1"
        assert row["device_coll_bytes"] == 0 and row["collective_ms"] == 0


def test_full_pod_cell_and_skip_rows():
    row = D.run_cell("qwen1.5-4b", "decode_32k", mesh="16x16",
                     overrides={"microbatches": 1}, verbose=False)
    assert row["status"] == "ok" and row["mesh"] == "data16xmodel16"
    assert row["chips"] == 256 and row["rank"] == 0
    assert row["fits"] is True and 0 < row["arg_gb"] < 80
    assert row["collective_ms"] > 0 and row["coll_by_kind"]
    assert set(row["coll_by_dim"]) <= {"data", "model"}
    assert row["links"] == {"data": 50.0, "model": 50.0}
    assert "rank 0 of 16x16" in row["notes"]
    reason = ref_get_config("qwen1.5-4b").supported_shapes()["long_500k"]
    for mesh, name in (("16x16", "pod16x16"), ("2x16x16", "pod2x16x16")):
        skip = D.run_cell("qwen1.5-4b", "long_500k", mesh=mesh,
                          verbose=False)
        assert skip == {"arch": "qwen1.5-4b", "shape": "long_500k",
                        "mesh": name, "status": "skip", "reason": reason}
