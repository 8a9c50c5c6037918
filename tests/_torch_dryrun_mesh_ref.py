"""The reference's side of `test_torch_dryrun_mesh.py`: its sharded step
compiled per device.

Run as a script (`run`) in a fresh interpreter with four forced host
devices.  Each job's mesh has **Auto** axes (the reference's own
`make_production_mesh` takes `jax.make_mesh`'s Explicit default, which
this jax refuses): ``("data", "model")`` for two sizes, ``("pod",
"data", "model")`` for three.  Per job the reference's
`step_builders.build` of the reduced config under ``use_mesh(mesh,
TRAIN_RULES)`` (as `repro/launch/dryrun.py:57` builds every kind) is
jitted with its shardings, lowered and compiled, and
`repro.utils.hlo.analyze` of the compiled text gives the per-device
FLOPs, bytes and wire bytes by kind; ``memory_analysis()`` the
argument and temporary bytes.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def job(arch: str, kind: str, mesh: tuple, *, seq: int = 32,
        batch: int = 4, overrides: dict | None = None) -> dict:
    return dict(arch=arch, kind=kind, mesh=list(mesh), seq=seq,
                batch=batch, overrides=overrides or {})


def start(jobs: list[dict], tmp: Path) -> subprocess.Popen:
    """The reference's jobs in a subprocess: its JSON result is written to
    ``tmp / "ref.json"`` (`result`)."""
    spec = tmp / "jobs.json"
    spec.write_text(json.dumps(jobs))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")]),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen(
        [sys.executable, str(Path(__file__)), str(spec),
         str(tmp / "ref.json")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def result(proc: subprocess.Popen, tmp: Path) -> list[dict]:
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-6000:]
    return json.loads((tmp / "ref.json").read_text())


def _run_job(j: dict) -> dict:
    import dataclasses

    import jax
    from jax.sharding import AxisType

    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.launch import step_builders as sb
    from repro.parallel import sharding as shd
    from repro.utils import hlo

    cfg = dataclasses.replace(get_config(j["arch"]).reduce(),
                              **j["overrides"])
    shape = tuple(j["mesh"])
    mesh = jax.make_mesh(shape, AXES[len(shape)],
                         axis_types=(AxisType.Auto,) * len(shape))
    with shd.use_mesh(mesh, shd.TRAIN_RULES) as ctx:
        art = sb.build(cfg, ShapeSpec("custom", j["seq"], j["batch"],
                                      j["kind"]), ctx)
        compiled = jax.jit(art.fn, in_shardings=art.in_shardings,
                           out_shardings=art.out_shardings,
                           donate_argnums=art.donate).lower(
                               *art.args).compile()
        mem = compiled.memory_analysis()
        text = compiled.as_text()
    cost = hlo.analyze(text)
    return {"flops": cost.flops, "bytes": cost.bytes,
            "coll_bytes": cost.coll_bytes,
            "coll_by_kind": dict(cost.coll_by_kind),
            "arg_bytes": mem.argument_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes}


def run(spec: str, out: str) -> None:
    jobs = json.loads(Path(spec).read_text())
    Path(out).write_text(json.dumps([_run_job(j) for j in jobs]))


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2])
