"""Both sides of the port's mesh training tests: the reference's training
under a mesh in a subprocess, the port's in spawned gloo ranks.

The reference runs this file as a script (`_torch_mesh_ref.run_reference`
with ``script=``, or `start_reference` to run it beside the port) in a
fresh interpreter with four forced host devices, each job's mesh with
**Auto** axes.  Jobs, by ``kind``:

* ``train`` — the reference's `build_train` under a ``("data",
  "model")`` mesh, jitted with its shardings, from the seeded f32
  weights of `_torch_lm_params` for ``steps`` pipeline batches from
  ``step0``; or with ``loop`` its `TrainLoop(mesh=)` from step 0 (the
  seeded weights in place of its own init), with ``ckpt`` a checkpoint
  directory and ``ckpt_every``.  Per step ``loss``, ``ce``, ``aux`` and
  ``grad_norm``; the params and optimizer state after the last step as
  (keystr path, numpy) lists; with ``spread`` each state leaf's spread
  when the same steps start from every weight moved by one f32 ulp; the
  embedding's spec;
* ``restore`` — the reference's `CheckpointManager.restore` of the
  job's directory under a mesh (after ``wait``, a path the port
  publishes, appears), ``shardings=`` its `build_train`'s shardings: the
  leaves as numpy;
* ``compress`` — `quantize_fp8_block` of each row of ``x`` (codes as
  uint8, scales), and `compressed_psum` over the four devices under
  ``shard_map``: the sum and each device's new error;
* ``pipeline`` — `pipeline_apply` over an Auto ``("pod",)`` mesh of the
  job's ``stages`` devices with a tanh-linear stage (`pipeline_stage`):
  the outputs and the gradients of ``sum(out ** 2)`` in the stage
  weights and the inputs;
* ``adamw8bit`` — `adamw8bit().update` op by op on a ``("data",
  "model")`` mesh, the seeded weights laid out by `param_shardings`,
  ``steps`` updates by the seeded gradients of `adam_grads` at
  ``lr``: per step each leaf's ``p_new - p_old``, then the params and
  the state (codes and scales);
* ``lm`` — `_torch_mesh_ref`'s LM job (the reference's sharded
  `Server`), so that one subprocess runs both kinds.

`port_train` is the port's side of ``train`` jobs (run on every rank),
`port_adamw8bit` of ``adamw8bit`` jobs, `port_jobs` of a list of
``lm``, ``train`` and ``adamw8bit`` jobs.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _env() -> dict:
    return {**os.environ,
            "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]),
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "JAX_PLATFORMS": "cpu"}


class Reference:
    """The reference's jobs running in a subprocess beside the caller."""

    def __init__(self, jobs: list[dict], tmp: Path):
        import pickle  # noqa: F401  (the result is a pickle)
        self.out = tmp / "ref_out.pkl"
        spec = tmp / "ref_jobs.json"
        spec.write_text(json.dumps(jobs))
        self.log = open(tmp / "ref_log.txt", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__)), str(spec), str(self.out)],
            env=_env(), cwd=ROOT, stdout=self.log, stderr=subprocess.STDOUT,
            text=True)

    def __enter__(self) -> "Reference":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # the caller failed first (a port rank raised): stop the
        # reference, which may be waiting for the port's checkpoint
        if exc_type is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def result(self) -> list[dict]:
        import pickle
        rc = self.proc.wait(timeout=600)
        self.log.seek(0)
        assert rc == 0, self.log.read()[-6000:]
        self.log.close()
        return pickle.loads(self.out.read_bytes())


def start_reference(jobs: list[dict], tmp: Path) -> Reference:
    return Reference(jobs, tmp)


def train_job(arch: str, mesh: tuple, *, steps: int = 2, step0: int = 100,
              batch: int = 4, seq: int = 32, overrides: dict | None = None,
              loop: bool = False, ckpt: str | None = None,
              ckpt_every: int = 50, spread: bool = False) -> dict:
    return dict(kind="train", arch=arch, overrides=overrides or {},
                mesh=list(mesh), steps=steps, step0=step0, batch=batch,
                seq=seq, loop=loop, ckpt=ckpt, ckpt_every=ckpt_every,
                spread=spread)


def lm_cfg(job: dict, ref: bool):
    import dataclasses
    if ref:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    return dataclasses.replace(get_config(job["arch"]).reduce(),
                               **job.get("overrides", {}))


def _data(cfg, job: dict, ref: bool):
    if ref:
        from repro.data import LMBatchSpec, SyntheticEmbeds, SyntheticLM
    else:
        from repro_torch.data.pipeline import (LMBatchSpec, SyntheticEmbeds,
                                               SyntheticLM)
    spec = LMBatchSpec(global_batch=job["batch"], seq_len=job["seq"],
                       vocab=cfg.vocab, n_shards=1, shard=0)
    if cfg.embed_inputs:
        return SyntheticLM(spec, seed=0)
    return SyntheticEmbeds(spec, cfg.d_model, seed=0)


# --------------------------------------------------------------------------
# the port's side (every rank)
# --------------------------------------------------------------------------


def _gather(tree) -> list:
    from torch.distributed.tensor import DTensor

    from repro_torch.utils.tree import leaves_with_path
    out = []
    for path, a in leaves_with_path(tree):
        if isinstance(a, DTensor):
            a = a.full_tensor()
        out.append((path, a.detach().cpu().numpy().copy()))
    return out


def port_loop(cfg, job: dict, tree, mesh, ckpt: str | None = None,
              steps: int | None = None):
    """The port's `TrainLoop` of ``job`` (``mesh`` None: mesh-free) whose
    fresh state is the seeded ``tree``: (history, params, opt_state)."""
    from repro_torch.launch import step_builders as sb
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import transformer as tfm
    from repro_torch.params import params_from_numpy
    from repro_torch.parallel import sharding as shd

    class Seeded(TrainLoop):
        def init_state(self, seed: int = 0):
            params = params_from_numpy(tree, "cpu")
            if self.ctx is not None:
                with shd.use_mesh(self.ctx.mesh, self.ctx.rules):
                    params = tfm.shard_params(params, cfg)
            return params, sb.init_opt_state(cfg, params, self.ctx), 0

    loop = Seeded(cfg, batch=job["batch"], seq=job["seq"], ckpt_dir=ckpt,
                  ckpt_every=job.get("ckpt_every", 50), device="cpu",
                  mesh=mesh)
    p, s, hist = loop.run(steps or job["steps"], log_every=1000)
    return hist, p, s


def port_train(jobs: list[dict], trees: list) -> list[dict]:
    """The port's side of ``train`` jobs: `build_train` under the job's
    mesh from ``step0`` (or, with ``loop``, its `TrainLoop`)."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import step_builders as sb
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.params import params_from_numpy
    from repro_torch.parallel import sharding as shd

    out = []
    for job, tree in zip(jobs, trees):
        cfg = lm_cfg(job, ref=False)
        mesh = make_local_mesh(*job["mesh"])
        if job.get("loop"):
            hist, params, state = port_loop(cfg, job, tree, mesh,
                                            ckpt=job.get("ckpt"))
            out.append({"history": hist, "params": _gather(params),
                        "opt": _gather(state)})
            continue
        ctx = shd.MeshContext(mesh, shd.TRAIN_RULES)
        with shd.use_mesh(mesh, shd.TRAIN_RULES):
            params = tfm.shard_params(params_from_numpy(tree, "cpu"), cfg)
            embed = params.get("embed")
            layout = None if embed is None else [str(p) for p in
                                                 embed.placements]
        state = sb.init_opt_state(cfg, params, ctx)
        step = sb.build_train(cfg, ShapeSpec("custom", job["seq"],
                                             job["batch"], "train"), ctx)
        data = _data(cfg, job, ref=False)
        metrics = []
        for i in range(job["steps"]):
            b = {k: torch.from_numpy(v) for k, v in
                 data.batch_at(job["step0"] + i).items()}
            params, state, m = step(params, state,
                                    sb.shard_batch(cfg, b, ctx),
                                    job["step0"] + i)
            metrics.append({k: float(v) for k, v in m.items()})
        out.append({"metrics": metrics, "params": _gather(params),
                    "opt": _gather(state), "embed_layout": layout})
    return out


def adam_job(arch: str, mesh: tuple, *, steps: int = 3, lr: float = 1e-3,
             overrides: dict | None = None) -> dict:
    return dict(kind="adamw8bit", arch=arch, overrides=overrides or {},
                mesh=list(mesh), steps=steps, lr=lr)


def adam_grads(tree, step: int):
    """Seeded gradients of the shapes of the numpy ``tree`` (dicts walked
    in sorted key order, lists in order): 0.01 * N(0, 1) from ``step``,
    the same arrays on either side."""
    rng = np.random.default_rng(1000 + step)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        a = np.asarray(node)
        return (0.01 * rng.standard_normal(a.shape)).astype(a.dtype)

    return walk(tree)


def port_adamw8bit(job: dict, tree, mesh_free: bool = False) -> dict:
    """The port's side of an ``adamw8bit`` job: `optim.adamw8bit`'s
    ``update_`` on the params laid out by the schema on the job's mesh
    (DTensors), or with ``mesh_free`` on plain tensors."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.optimizers import adamw8bit
    from repro_torch.params import params_from_numpy
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import leaves

    cfg = lm_cfg(job, ref=False)
    mesh = None if mesh_free else make_local_mesh(*job["mesh"])

    def lay(t):
        t = params_from_numpy(t, "cpu")
        if mesh is None:
            return t
        with shd.use_mesh(mesh, shd.TRAIN_RULES):
            return tfm.shard_params(t, cfg)

    def whole(a):
        return a.full_tensor() if mesh is not None else a

    params = lay(tree)
    opt = adamw8bit()
    state = opt.init(params)
    deltas = []
    for i in range(job["steps"]):
        before = [whole(p).clone() for p in leaves(params)]
        opt.update_(lay(adam_grads(tree, i)), state, params, job["lr"])
        deltas.append([(whole(p) - b).numpy() for p, b in
                       zip(leaves(params), before)])
    return {"deltas": deltas, "params": _gather(params),
            "opt": _gather(state)}


def port_jobs(jobs: list[dict], trees: list) -> list[dict]:
    """The port's side of ``lm``, ``train`` and ``adamw8bit`` jobs, in
    one world (``adamw8bit`` also mesh-free, under ``"mesh_free"``)."""
    from _torch_mesh_ref import port_lm
    out = []
    for job, tree in zip(jobs, trees):
        if job["kind"] == "lm":
            out.extend(port_lm([job], [tree]))
        elif job["kind"] == "train":
            out.extend(port_train([job], [tree]))
        else:
            res = port_adamw8bit(job, tree)
            res["mesh_free"] = port_adamw8bit(job, tree, mesh_free=True)
            out.append(res)
    return out


# --------------------------------------------------------------------------
# the reference side (runs in the subprocess)
# --------------------------------------------------------------------------


def _auto_mesh(shape, names):
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh(tuple(shape), tuple(names),
                         axis_types=(AxisType.Auto,) * len(shape))


def _np_leaves(tree) -> list:
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(a)) for p, a in flat]


def _ref_train(job: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from _torch_lm_params import seeded_params
    from repro.configs.base import ShapeSpec
    from repro.launch import step_builders as RSB
    from repro.launch.train import TrainLoop
    from repro.parallel import sharding as shd

    cfg = lm_cfg(job, ref=True)
    mesh = _auto_mesh(job["mesh"], ("data", "model"))
    tree = jax.tree.map(jnp.asarray, seeded_params(cfg))
    if job.get("loop"):
        class Seeded(TrainLoop):
            def init_state(self, seed=0):
                with shd.use_mesh(*self.ctx_args):
                    return tree, self.opt.init(tree), 0

        loop = Seeded(cfg, batch=job["batch"], seq=job["seq"],
                      ckpt_dir=job.get("ckpt"),
                      ckpt_every=job.get("ckpt_every", 50), mesh=mesh)
        params, state, hist = loop.run(job["steps"], log_every=1000)
        return {"history": [float(h) for h in hist],
                "params": _np_leaves(params), "opt": _np_leaves(state)}
    with shd.use_mesh(mesh, shd.TRAIN_RULES) as ctx:
        art = RSB.build_train(cfg, ShapeSpec("custom", job["seq"],
                                             job["batch"], "train"), ctx)
        fn = jax.jit(art.fn, in_shardings=art.in_shardings,
                     out_shardings=art.out_shardings)
        data = _data(cfg, job, ref=True)

        def run(start):
            params = jax.device_put(start, art.in_shardings[0])
            state = jax.device_put(RSB.make_optimizer(cfg).init(start),
                                   art.in_shardings[1])
            metrics = []
            for i in range(job["steps"]):
                b = {k: jnp.asarray(v) for k, v in
                     data.batch_at(job["step0"] + i).items()}
                params, state, m = fn(params, state, b,
                                      jnp.int32(job["step0"] + i))
                metrics.append({k: float(v) for k, v in m.items()})
            return params, state, metrics

        params, state, metrics = run(tree)
        spread = None
        if job.get("spread"):
            # the same compiled steps from every weight moved by one ulp
            rng = np.random.default_rng(7)
            ulp = jax.tree.map(lambda a: jnp.asarray((np.asarray(a) * (
                1 + rng.choice([-1, 1], a.shape) * 2.0 ** -23)).astype(
                    a.dtype)), tree)
            _, state_ulp, _ = run(ulp)
            spread = [_l2(a, b) for (_, a), (_, b) in
                      zip(_np_leaves(state), _np_leaves(state_ulp))]
        embed = params.get("embed")
        return {"metrics": metrics, "params": _np_leaves(params),
                "opt": _np_leaves(state), "opt_ulp_spread": spread,
                "embed_spec": None if embed is None else
                str(tuple(embed.sharding.spec))}


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def state_bound(ref: dict, i: int, rtol: float) -> float:
    """The bound of optimizer-state leaf ``i``: ``rtol`` or, where larger,
    twice the reference's own spread when its weights move by one f32
    ulp (`_ref_train`'s ``opt_ulp_spread``): the moments are functions of
    the gradients, and some archs' gradients are ill-conditioned at these
    weights (RWKV-6's time mix, Jamba's Mamba mixers)."""
    return max(rtol, 2 * ref["opt_ulp_spread"][i])


def wait_for(path: str, timeout: float = 600.0) -> None:
    """Poll until ``path`` exists: a checkpoint the other side publishes
    (its manifest appears with the atomic rename of its directory)."""
    import time
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def _ref_restore(job: dict) -> dict:
    import jax

    from repro.checkpoint import CheckpointManager
    from repro.configs.base import ShapeSpec
    from repro.launch import step_builders as RSB
    from repro.parallel import sharding as shd

    cfg = lm_cfg(job, ref=True)
    mesh = _auto_mesh(job["mesh"], ("data", "model"))
    if job.get("wait"):
        wait_for(job["wait"])
    with shd.use_mesh(mesh, shd.TRAIN_RULES) as ctx:
        art = RSB.build_train(cfg, ShapeSpec("custom", job["seq"],
                                             job["batch"], "train"), ctx)
        target = {"params": art.args[0], "opt": art.args[1]}
        shardings = {"params": art.in_shardings[0],
                     "opt": art.in_shardings[1]}
        tree, step, _ = CheckpointManager(job["ckpt"]).restore(
            target, job.get("step"), shardings=shardings)
    lay = str(tuple(tree["params"]["embed"].sharding.spec)) \
        if "embed" in tree["params"] else None
    return {"step": step, "leaves": _np_leaves(jax.tree.map(np.asarray,
                                                            tree)),
            "embed_spec": lay}


def _ref_compress(job: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as PS

    from repro.parallel import compression as C

    x = np.asarray(job["x"], np.float32)       # (4, *shape)
    err = np.asarray(job["err"], np.float32)
    block = job["block"]
    codes, scales, pads = [], [], []
    for row in x:
        q, s, pad = C.quantize_fp8_block(jnp.asarray(row), block)
        codes.append(np.asarray(q).view(np.uint8))
        scales.append(np.asarray(s))
        pads.append(int(pad))
    mesh = _auto_mesh((4,), ("pod",))
    spec = PS("pod", *([None] * (x.ndim - 1)))

    def body(xs, es):
        tot, new = C.compressed_psum(xs[0], "pod", es[0], block)
        return tot[None], new[None]

    tot, new = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=(spec, spec), check_rep=False))(
        jnp.asarray(x), jnp.asarray(err))
    return {"codes": codes, "scales": scales, "pads": pads,
            "sum": np.asarray(tot), "new_err": np.asarray(new)}


def pipeline_stage(sp, x, xp):
    """The tests' stage on either side (``xp``: ``jax.numpy`` or
    ``torch``): tanh(x @ w + b)."""
    return xp.tanh(x @ sp["w"] + sp["b"])


def _ref_pipeline(job: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.parallel.pipeline import pipeline_apply

    mesh = _auto_mesh((job["stages"],), ("pod",))
    w = {k: jnp.asarray(np.asarray(job[k], np.float32)) for k in "wb"}
    x = jnp.asarray(np.asarray(job["x"], np.float32))   # (M, B, D)

    def fn(w, x):
        out = pipeline_apply(mesh, lambda sp, xi: pipeline_stage(sp, xi, jnp),
                             w, x, pod_axis="pod")
        return jnp.sum(out ** 2), out

    (_, out), (gw, gx) = jax.jit(jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True))(w, x)
    return {"out": np.asarray(out), "gw": np.asarray(gw["w"]),
            "gb": np.asarray(gw["b"]), "gx": np.asarray(gx)}


def _ref_adamw8bit(job: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from _torch_lm_params import seeded_params
    from repro.launch import step_builders as RSB
    from repro.optim.optimizers import adamw8bit
    from repro.parallel import sharding as shd

    cfg = lm_cfg(job, ref=True)
    mesh = _auto_mesh(job["mesh"], ("data", "model"))
    tree = seeded_params(cfg)
    opt = adamw8bit()
    with shd.use_mesh(mesh, shd.TRAIN_RULES) as ctx:
        sh, _ = RSB.param_shardings(cfg, ctx)
        params = jax.device_put(jax.tree.map(jnp.asarray, tree), sh)
        state = opt.init(params)
        # op by op, not jitted: under jit XLA rewrites ``amax / 127.0``
        # (`_q8`) into a multiply by the f32 reciprocal, which moves 5%
        # of the scales by an ulp; each op still runs under GSPMD on the
        # sharded global arrays
        def step(g, s, p):
            return opt.update(g, s, p, job["lr"])
        deltas = []
        for i in range(job["steps"]):
            g = jax.device_put(jax.tree.map(jnp.asarray,
                                            adam_grads(tree, i)), sh)
            u, state = step(g, state, params)
            new = jax.tree.map(lambda p, d: p + d, params, u)
            deltas.append([np.asarray(a) - np.asarray(b) for a, b in
                           zip(jax.tree.leaves(new),
                               jax.tree.leaves(params))])
            params = new
    return {"deltas": deltas, "params": _np_leaves(params),
            "opt": _np_leaves(state)}


def _ref_lm(job: dict) -> dict:
    from _torch_mesh_ref import _ref_lm as ref_lm
    return ref_lm(job)


_REF = {"train": _ref_train, "restore": _ref_restore,
        "compress": _ref_compress, "pipeline": _ref_pipeline,
        "adamw8bit": _ref_adamw8bit, "lm": _ref_lm}


def _main(spec: str, out: str) -> None:
    import pickle
    jobs = json.loads(Path(spec).read_text())
    res = [_REF[j["kind"]](j) for j in jobs]
    Path(out).write_bytes(pickle.dumps(res))


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
