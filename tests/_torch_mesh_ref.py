"""Both sides of the port's mesh tests: the reference under a mesh in a
subprocess, the port in spawned gloo ranks.

`run_reference` runs this file as a script in a fresh interpreter with
four forced host devices (``XLA_FLAGS``) and an exact ``jnp.exp2`` of
whole numbers (`exact_exp2`: the reference's int8 activation scales are
powers of two), builds each job's mesh with
**Auto** axes (``jax.make_mesh``'s default on this jax is Explicit, and
the reference's `logical` refuses that), hands it to the reference's
entry points as ``mesh=`` and saves numpy results.  Jobs:

* ``lm`` — the reference's `Server` on a reduced LM config (the seeded
  weights of `_torch_lm_params`), its greedy streams, decode steps and
  backfills over the job's traffic, and its prefill logits on the job's
  probe batch;
* ``cnn`` — the reference's `ReplicaGroup(shard_fc=True)` over the
  ``("model",)`` mesh of the four devices, serving the job's images with
  the seeded ResNet-18 tree (or the job's ``net``), its logits; with
  ``conv`` the serving rules map ``conv`` to ``model`` (cout-sharded
  convs), and every entry's strip spec comes back;
* ``fleet`` — the reference's `ReplicaGroup(shard_fc=True, replicas=R)`
  over its (data, model) grid of the four devices behind a
  `FleetScheduler` (each replica in a `ChaosBackend` when the job has a
  ``chaos`` seed), serving the job's images: each request's logits and
  outcome, the runs' stats, the fleet's waves.

`spawn_port` runs a function in ``world`` spawned processes joined in a
gloo world through one ``file://`` store under the test's temporary
directory (the tier-1 run has several pytest workers at once, so no TCP
port); rank 0's return value comes back through a pickle.  `port_lm`
and `port_cnn` are the port's side of the same jobs, run on every rank.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def run_reference(jobs: list[dict], tmp: Path) -> list[dict]:
    """Run ``jobs`` through the reference (one subprocess) -> one dict of
    numpy results a job."""
    spec = tmp / "ref_jobs.json"
    out = tmp / "ref_out.pkl"
    spec.write_text(json.dumps(jobs))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")]),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, str(Path(__file__)), str(spec),
                        str(out)], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    return pickle.loads(out.read_bytes())


def _port_entry(rank: int, world: int, store: str, out: str, fn, args
                ) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group
    torch.set_num_threads(1)
    init_process_group(store, rank=rank, world_size=world, device="cpu")
    try:
        res = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        Path(out).write_bytes(pickle.dumps(res))


def spawn_port(fn, args: tuple, tmp: Path, world: int = 4):
    """``fn(*args)`` on every rank of a ``world``-rank gloo world ->
    rank 0's result.  ``fn`` must be importable (module level)."""
    import torch.multiprocessing as mp
    store, out = tmp / "port_store", tmp / "port_out.pkl"
    mp.spawn(_port_entry, args=(world, str(store), str(out), fn, args),
             nprocs=world, join=True)
    return pickle.loads(out.read_bytes())


def lm_jobs(specs: list[tuple], *, batch: int = 4, capacity: int = 64,
            seed: int = 0) -> list[dict]:
    """LM jobs (arch, config overrides, (data, model)) over one seeded
    traffic: six requests of 18-30 tokens and 3-9 new ones at batch 4, so
    slots retire and backfill, and a (4, 32) probe batch for the prefill
    logits."""
    rng = np.random.default_rng(seed)
    traffic = [(i, rng.integers(0, 512, int(rng.integers(18, 31))).tolist(),
                int(rng.integers(3, 10))) for i in range(6)]
    probe = rng.integers(0, 512, (4, 32)).tolist()
    return [dict(kind="lm", arch=a, overrides=o, mesh=list(m), batch=batch,
                 capacity=capacity, traffic=traffic, probe=probe)
            for a, o, m in specs]


def port_lm(jobs: list[dict], trees: list) -> list[dict]:
    """The port's side of LM jobs (run on every rank): its `Server` with
    ``mesh=`` over the world, the reference's seeded weights."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as TS
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.params import params_from_numpy
    from repro_torch.parallel import sharding as shd

    out = []
    for job, tree in zip(jobs, trees):
        cfg = dataclasses.replace(get_config(job["arch"]).reduce(),
                                  **job.get("overrides", {}))
        mesh = make_local_mesh(*job["mesh"])
        srv = TS.Server(cfg, batch=job["batch"], capacity=job["capacity"],
                        device="cpu", params=params_from_numpy(tree, "cpu"),
                        mesh=mesh)
        reqs = [TS.Request(rid=r, prompt=np.asarray(p, np.int32), max_new=m)
                for r, p, m in job["traffic"]]
        stats = srv.serve(reqs)
        toks = torch.from_numpy(np.asarray(job["probe"], np.int64))
        with shd.use_mesh(mesh, shd.SERVE_RULES):
            logits, caches = tfm.prefill(
                srv.params, {"tokens": shd.distribute(toks, ("batch", None))},
                cfg, capacity=job["capacity"])
            k = caches[0]["l0"]["mix"].get("k") if "k" in \
                caches[0]["l0"].get("mix", {}) else None
            layout = None if k is None else [str(p) for p in k.placements]
            logits = logits.full_tensor().numpy()
        out.append({"streams": [list(map(int, r.out)) for r in reqs],
                    "steps": [s["decode_steps"] for s in stats],
                    "backfills": [s["backfills"] for s in stats],
                    "prefill_logits": logits, "cache_layout": layout})
    return out


def cnn_net(job: dict, ref: bool):
    """The job's CNN (``net``: ``resnet18`` by default) with its head."""
    if ref:
        from repro.models import graph as G
    else:
        from repro_torch.models import graph as G
    return getattr(G, "build_" + job.get("net", "resnet18"))(job["classes"])


def _strip_spec(vals) -> object:
    """The port's strip spec of an entry: ``"model"`` where its strips
    are sharded, else None (the reference's ``spec[0]``)."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(vals, DTensor) and any(isinstance(p, Shard)
                                         for p in vals.placements):
        return "model"
    return None


def port_cnn_conv(job: dict, tree) -> dict:
    """The port's side of a ``cnn`` job with ``conv``: its
    `ReplicaGroup(shard_fc=True)` over the world with ``conv`` on
    ``model``, and `net_apply` on one device."""
    import torch

    from repro_torch.launch.serve import ReplicaGroup
    from repro_torch.models import graph as tg
    from repro_torch.params import params_from_numpy
    from repro_torch.parallel import sharding as shd

    net = cnn_net(job, ref=False)
    params = params_from_numpy(tree, "cpu")
    sparse, _ = tg.sparsify(net, params, job["density"], vk=32, vn=128,
                            dtype=job.get("dtype"))
    group = ReplicaGroup(net, params, sparse=sparse, density=job["density"],
                         replicas=1, shard_fc=True, device="cpu",
                         rules=shd.SERVE_RULES.replace(conv="model"))
    images = np.asarray(job["images"], np.float32)
    apply = group.backends[0].apply
    y = apply(images.shape, lambda o: o.__setitem__(slice(None), images))
    one = tg.net_apply(net, params, torch.from_numpy(images), sparse=sparse)
    return {"logits": y.numpy().copy(), "one": one.numpy(),
            "specs": {n: _strip_spec(e.vs.vals) for n, e in
                      apply.sparse.items()}}


def fleet_requests(job: dict, ref: bool) -> list:
    if ref:
        from repro.launch.serve import ImageRequest
    else:
        from repro_torch.launch.serve import ImageRequest
    return [ImageRequest(rid=i, image=im) for i, im in
            enumerate(np.asarray(job["images"], np.float32))]


def fleet_result(sch, reqs) -> dict:
    """A served fleet's logits by request, outcomes, runs' stats (no
    times) and waves."""
    return {"logits": {r.rid: np.asarray(r.logits) for r in reqs
                       if r.logits is not None},
            "outcomes": {rid: (o.status, o.reason, o.replica, o.attempts,
                               o.wave) for rid, o in sch.outcomes.items()},
            "stats": [{k: v for k, v in st.items() if not k.endswith("_s")}
                      for st in sch.last_stats],
            "waves": sch.waves}


def port_cnn_fleet(job: dict, tree) -> dict:
    """The port's side of a ``fleet`` job: its `ReplicaGroup(shard_fc=
    True)` over the world's (data, model) grid, and the same fleet on
    this rank alone (``shard_fc=False``, every replica on one device)."""
    from repro_torch.launch.faults import ChaosBackend, FaultPlan
    from repro_torch.launch.scheduler import FleetScheduler
    from repro_torch.launch.serve import ReplicaGroup
    from repro_torch.models import graph as tg
    from repro_torch.params import params_from_numpy

    net = cnn_net(job, ref=False)
    params = params_from_numpy(tree, "cpu")
    sparse, _ = tg.sparsify(net, params, job["density"], vk=32, vn=128,
                            dtype=job.get("dtype"))
    out = {}
    for name, shard in (("fleet", True), ("one", False)):
        group = ReplicaGroup(net, params, sparse=sparse,
                             density=job["density"],
                             replicas=job["replicas"], shard_fc=shard,
                             device="cpu")
        backends = list(group.backends)
        if job.get("chaos") is not None:
            plan = FaultPlan.random(job["chaos"], replicas=job["replicas"])
            backends = [ChaosBackend(b, plan, replica=i)
                        for i, b in enumerate(backends)]
        sch = FleetScheduler(backends, batch=job["batch"])
        reqs = fleet_requests(job, ref=False)
        sch.last_stats = sch.serve(reqs)
        out[name] = fleet_result(sch, reqs)
        if shard:
            out["mesh"] = (None if group.mesh is None else
                           dict(zip(group.mesh.mesh_dim_names,
                                    group.mesh.mesh.shape)))
    return out


def port_cnn_jobs(jobs: list[dict], trees: list) -> list[dict]:
    """The port's side of ``cnn`` jobs with ``conv`` and of ``fleet``
    jobs, in one world."""
    return [port_cnn_fleet(j, t) if j["kind"] == "fleet"
            else port_cnn_conv(j, t) for j, t in zip(jobs, trees)]


def port_cnn(jobs: list[dict], trees: list) -> list[dict]:
    """The port's side of CNN jobs (run on every rank): its
    `ReplicaGroup(shard_fc=True)` over the world, and `net_apply` on one
    device, with the reference's weights sparsified by the port."""
    import torch

    from repro_torch.launch.serve import ReplicaGroup
    from repro_torch.models import graph as tg
    from repro_torch.params import params_from_numpy

    out = []
    for job, tree in zip(jobs, trees):
        net = tg.build_resnet18(job["classes"])
        params = params_from_numpy(tree, "cpu")
        sparse, _ = tg.sparsify(net, params, job["density"], vk=32, vn=128,
                                dtype=job.get("dtype"))
        group = ReplicaGroup(net, params, sparse=sparse,
                             density=job["density"], replicas=1,
                             shard_fc=True, device="cpu")
        images = np.asarray(job["images"], np.float32)
        apply = group.backends[0].apply
        y = apply(images.shape, lambda o: o.__setitem__(slice(None), images))
        one = tg.net_apply(net, params, torch.from_numpy(images),
                           sparse=sparse)
        out.append({"logits": y.numpy().copy(), "one": one.numpy(),
                    "mesh": dict(zip(group.mesh.mesh_dim_names,
                                     group.mesh.mesh.shape)),
                    "fc_local": {n: tuple(e.vs.vals.to_local().shape)
                                 for n, e in apply.sparse.items()
                                 if isinstance(e, tg.SparseFC)}})
    return out


# --------------------------------------------------------------------------
# the reference side (runs in the subprocess)
# --------------------------------------------------------------------------


def _auto_mesh(shape, names):
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(tuple(shape), tuple(names),
                         axis_types=(AxisType.Auto,) * len(shape))


def lm_cfg(job):
    import dataclasses

    from repro.configs import get_config
    cfg = get_config(job["arch"]).reduce()
    return dataclasses.replace(cfg, **job.get("overrides", {}))


def _ref_lm(job: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from _torch_lm_params import seeded_params
    from repro.launch import serve as RS
    from repro.models import transformer as RT
    from repro.parallel import sharding as shd

    cfg = lm_cfg(job)
    mesh = _auto_mesh(job["mesh"], ("data", "model"))
    params = jax.tree.map(jnp.asarray, seeded_params(cfg))
    srv = RS.Server(cfg, batch=job["batch"], capacity=job["capacity"],
                    mesh=mesh)
    srv.params = srv.backend.params = params
    reqs = [RS.Request(rid=r, prompt=np.asarray(p, np.int32), max_new=m)
            for r, p, m in job["traffic"]]
    stats = srv.serve(reqs)
    toks = jnp.asarray(np.asarray(job["probe"], np.int32))
    with shd.use_mesh(mesh, shd.SERVE_RULES):
        logits, _ = jax.jit(lambda p, b: RT.prefill(
            p, b, cfg, capacity=job["capacity"]))(params, {"tokens": toks})
    return {"streams": [list(map(int, r.out)) for r in reqs],
            "steps": [s["decode_steps"] for s in stats],
            "backfills": [s["backfills"] for s in stats],
            "prefill_logits": np.asarray(logits)}


def _ref_cnn(job: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.launch import serve as RS
    from repro.parallel import sharding as shd

    net = cnn_net(job, ref=True)
    params = jax.tree.map(jnp.asarray, cnn_params(job))
    sparse, _ = net.sparsify(params, job["density"], vk=32, vn=128,
                             dtype=job.get("dtype"))
    rules = shd.SERVE_RULES.replace(conv="model") if job.get("conv") \
        else None
    group = RS.ReplicaGroup(net, params, sparse=sparse, impl="jnp",
                            density=job["density"], replicas=1,
                            shard_fc=True, rules=rules, validate=False)
    mesh = group.meshes[0]
    assert dict(mesh.shape) == {"model": 4}, mesh.shape
    apply = group.backends[0].apply
    images = np.asarray(job["images"], np.float32)
    return {"logits": np.asarray(apply(jnp.asarray(images))),
            "fc_specs": {n: tuple(e.vs.vals.sharding.spec)
                         for n, e in apply.sparse.items()
                         if type(e).__name__ == "SparseFC"},
            "specs": {n: tuple(e.vs.vals.sharding.spec)[0]
                      for n, e in apply.sparse.items()}}


def _ref_fleet(job: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.launch import serve as RS
    from repro.launch.faults import ChaosBackend, FaultPlan
    from repro.launch.scheduler import FleetScheduler

    net = cnn_net(job, ref=True)
    params = jax.tree.map(jnp.asarray, cnn_params(job))
    sparse, _ = net.sparsify(params, job["density"], vk=32, vn=128,
                             dtype=job.get("dtype"))
    group = RS.ReplicaGroup(net, params, sparse=sparse, impl="jnp",
                            density=job["density"],
                            replicas=job["replicas"], shard_fc=True,
                            validate=False)
    backends = list(group.backends)
    if job.get("chaos") is not None:
        plan = FaultPlan.random(job["chaos"], replicas=job["replicas"])
        backends = [ChaosBackend(b, plan, replica=i)
                    for i, b in enumerate(backends)]
    sch = FleetScheduler(backends, batch=job["batch"])
    reqs = fleet_requests(job, ref=True)
    sch.last_stats = sch.serve(reqs)
    out = fleet_result(sch, reqs)
    out["meshes"] = [dict(m.shape) for m in group.meshes]
    return out


def cnn_params(job: dict) -> dict:
    """A CNN job's weights: the reference's init of the job's net
    (ResNet-18 by default) with its head from ``seed``, as numpy, so that
    the port gets the same tree."""
    import jax
    import jax.numpy as jnp

    from repro.models.layers import init_params
    net = cnn_net(job, ref=True)
    return jax.tree.map(np.asarray, init_params(
        net.schema(), jax.random.PRNGKey(job["seed"]), jnp.float32))


_REF = {"lm": lambda j: _ref_lm(j), "cnn": lambda j: _ref_cnn(j),
        "fleet": lambda j: _ref_fleet(j)}


def exact_exp2() -> None:
    """Make ``jnp.exp2`` of a whole number the exact power of two.  The
    reference rounds int8 activation scales up to a power of two by
    ``exp2(ceil(log2(s)))`` (`repro.models.graph.quantize_activations_int8`,
    its only ``jnp.exp2``); this jax's CPU ``exp2`` misses 2^k for many
    k (k = -13 gives 1.2207025e-4, not 2^-13 = 1.2207031e-4), and the
    scale is then no power of two, as the reference's docstring says it
    is.  Elsewhere ``exp2`` is left as it is."""
    import jax.numpy as jnp
    inexact = jnp.exp2

    def exp2(x):
        k = jnp.round(x)
        return jnp.where(k == x, jnp.ldexp(jnp.ones_like(x),
                                           k.astype(jnp.int32)), inexact(x))

    jnp.exp2 = exp2


def _main(spec: str, out: str) -> None:
    exact_exp2()
    jobs = json.loads(Path(spec).read_text())
    res = [_REF[j["kind"]](j) for j in jobs]
    Path(out).write_bytes(pickle.dumps(res))


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
