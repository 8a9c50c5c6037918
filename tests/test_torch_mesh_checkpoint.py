"""Sharded checkpoints of the port's training under a mesh, across both
sides and across meshes, on the CPU.

Reduced Qwen1.5-4B from the seeded f32 weights (`_torch_lm_params`),
batch 4 x 32, in four gloo ranks (`_torch_mesh_ref.spawn_port`) and in
the reference's subprocess on Auto meshes of four host devices
(`_torch_mesh_train_ref`):

* the port's 2x2 `TrainLoop` saves at step 2 and a second loop resumes
  to step 3: its losses, params and optimizer state are bit-equal to an
  uninterrupted 3-step run (each leaf gathered to rank 0, which writes;
  restore lays it out again);
* that 4-rank checkpoint restores in the reference's `CheckpointManager`
  (``shardings=`` its 2x2 `build_train`'s) bit for bit;
* the reference's 2x2 `TrainLoop` checkpoint (step 3) restores into the
  port bit for bit on a 1x4 mesh (`TrainLoop.maybe_resume`: each leaf
  laid out as the fresh state's), through ``shardings=`` (the
  `NamedSharding`s of `step_builders`) and with no mesh.
"""
import numpy as np
import pytest

from _torch_lm_params import seeded_params
from _torch_mesh_ref import spawn_port
from _torch_mesh_train_ref import _gather, lm_cfg, port_loop, \
    start_reference, train_job, wait_for
from _torch_threads import one_torch_thread  # noqa: F401

JOB = train_job("qwen1.5-4b", (2, 2), loop=True, steps=3, step0=0)


def _port(job: dict, tree, port_ckpt: str, ref_ckpt: str) -> dict:
    """Save and resume on 2x2 into ``port_ckpt``; then, once the
    reference has published its step 3 in ``ref_ckpt``, restore it."""
    import torch.distributed as dist
    saved = _port_save_resume(job, tree, port_ckpt)
    if dist.get_rank() == 0:
        wait_for(f"{ref_ckpt}/step_3/manifest.json")
    dist.barrier()
    return saved, _port_restore(job, ref_ckpt)


def _port_save_resume(job: dict, tree, ckpt: str) -> dict:
    from repro_torch.launch.mesh import make_local_mesh
    cfg = lm_cfg(job, ref=False)
    mesh = make_local_mesh(2, 2)
    h_whole, p_whole, s_whole = port_loop(cfg, job, tree, mesh, steps=3)
    h_a, _, _ = port_loop(cfg, job, tree, mesh, ckpt=ckpt, steps=2)
    h_b, p_res, s_res = port_loop(cfg, job, tree, mesh, ckpt=ckpt, steps=3)
    return {"whole": (h_whole, _gather(p_whole), _gather(s_whole)),
            "resumed": (h_a + h_b, _gather(p_res), _gather(s_res)),
            "layout": [str(p) for p in p_res["embed"].placements]}


def _port_restore(job: dict, ckpt: str) -> dict:
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import step_builders as sb
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as shd

    cfg = lm_cfg(job, ref=False)
    out = {}
    mesh = make_local_mesh(1, 4)
    loop = TrainLoop(cfg, batch=job["batch"], seq=job["seq"],
                     ckpt_dir=ckpt, device="cpu", mesh=mesh)
    p, s, step = loop.maybe_resume()
    out["1x4"] = (step, _gather({"params": p, "opt": s}),
                  [str(x) for x in p["embed"].placements])
    free = TrainLoop(cfg, batch=job["batch"], seq=job["seq"],
                     ckpt_dir=ckpt, device="cpu")
    p, s, step = free.maybe_resume()
    out["free"] = (step, _gather({"params": p, "opt": s}))
    # `shardings=`: a mesh-free target laid out by NamedShardings
    ctx = shd.MeshContext(mesh, shd.TRAIN_RULES)
    p0, s0, _ = free.init_state()
    p_sh, _ = sb.param_shardings(cfg, ctx)
    s_sh = sb.tree_shardings(sb.opt_state_axes(cfg, tfm.lm_schema(cfg)),
                             s0, ctx)
    tree, step, _ = CheckpointManager(ckpt).restore(
        {"params": p0, "opt": s0}, shardings={"params": p_sh, "opt": s_sh})
    out["shardings"] = (step, _gather(tree),
                        [str(x) for x in tree["params"]["embed"].placements])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One reference subprocess (train and save, then restore the port's
    checkpoint once it appears) beside one spawn of the port's ranks
    (save and resume, then restore the reference's once it appears)."""
    tree = seeded_params(lm_cfg(JOB, ref=True))
    ref_dir = str(tmp_path_factory.mktemp("ref_ckpt"))
    port_dir = str(tmp_path_factory.mktemp("port_ckpt"))
    jobs = [dict(JOB, ckpt=ref_dir, ckpt_every=2),
            dict(kind="restore", arch=JOB["arch"], mesh=[2, 2],
                 batch=JOB["batch"], seq=JOB["seq"], ckpt=port_dir, step=3,
                 wait=f"{port_dir}/step_3/manifest.json")]
    with start_reference(jobs, tmp_path_factory.mktemp("ref")) as ref:
        saved, restored = spawn_port(_port, (JOB, tree, port_dir, ref_dir),
                                     tmp_path_factory.mktemp("port"))
        ref_a, ref_b = ref.result()
    return saved, ref_a, ref_b, restored


def _equal(a: list, b: list) -> None:
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


def test_resume_equals_an_uninterrupted_run(runs):
    saved = runs[0]
    h_whole, p_whole, s_whole = saved["whole"]
    h_res, p_res, s_res = saved["resumed"]
    assert len(h_res) == 3 and h_res == h_whole
    _equal(p_res, p_whole)
    _equal(s_res, s_whole)
    assert saved["layout"] == ["S(1)", "S(0)"]


def test_port_checkpoint_restores_in_the_reference(runs):
    saved, _, ref_b, _ = runs
    assert ref_b["step"] == 3
    assert ref_b["embed_spec"] == "('model', 'data')"
    _, p_res, s_res = saved["resumed"]
    _equal(ref_b["leaves"], [("['opt']" + k, v) for k, v in s_res] +
           [("['params']" + k, v) for k, v in p_res])


@pytest.mark.parametrize("where", ["1x4", "free", "shardings"])
def test_reference_checkpoint_restores_in_the_port(runs, where):
    _, ref_a, _, restored = runs
    step, leaves = restored[where][:2]
    assert step == 3
    _equal(leaves, [("['opt']" + k, v) for k, v in ref_a["opt"]] +
           [("['params']" + k, v) for k, v in ref_a["params"]])


def test_restore_lays_the_leaves_out_on_the_new_mesh(runs):
    """On 1x4 the embedding's vocab rows are on the model dim (4 ranks)
    and its D dim on the data dim of one rank."""
    restored = runs[3]
    assert restored["1x4"][2] == ["S(1)", "S(0)"]
    assert restored["shardings"][2] == ["S(1)", "S(0)"]
