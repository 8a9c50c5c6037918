"""The port's training under a mesh against the reference's, on the CPU.

The reference runs in a subprocess with four host devices on Auto
``("data", "model")`` meshes (`_torch_mesh_train_ref`); the port in four
gloo ranks (`_torch_mesh_ref.spawn_port`), both from the same seeded f32
weights (`_torch_lm_params.seeded_params`) and the same pipeline batches
(4 x 32).  Each side's `build_train` under its mesh runs two steps from
step 100 (lr 1.5e-4; at step 0 the schedule gives lr 0):

* reduced Qwen1.5-4B (``attn_sharding="sp"``: each rank's flash queries
  are its slice of the sequence at ``q_offset``) on 2x2, 1x4 and 4x1,
  and on 2x2 with 2 microbatches (each a slice of the *global* batch);
* reduced Nemotron-4 (Adafactor: its factored moments laid out by
  ``state_axes``, their means summed over the sharded dims);
* reduced HuBERT-XLarge (embeddings in, non-causal, ``heads``);

and each side's `TrainLoop(mesh=)` three steps from step 0 of Qwen on
2x2 (the loop's global batch, distributed).

Tolerances (the port's one-device bounds): loss, ce, aux and grad norm
each step within 1e-5 relative; each parameter and optimizer-state leaf
after the last step within 1e-5 relative in the L2 norm.  The embedding
is laid out as the reference's ``PartitionSpec('model', 'data')``.
"""
import numpy as np
import pytest

from _torch_lm_params import seeded_params
from _torch_mesh_ref import spawn_port
from _torch_mesh_train_ref import lm_cfg, port_train, start_reference, \
    train_job
from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
CASES = {
    "qwen-2x2": train_job("qwen1.5-4b", (2, 2)),
    "qwen-1x4": train_job("qwen1.5-4b", (1, 4)),
    "qwen-4x1": train_job("qwen1.5-4b", (4, 1)),
    "qwen-2x2-mb2": train_job("qwen1.5-4b", (2, 2),
                              overrides={"microbatches": 2}),
    "nemotron-adafactor": train_job("nemotron-4-340b", (2, 2)),
    "hubert": train_job("hubert-xlarge", (2, 2)),
}
LOOP = train_job("qwen1.5-4b", (2, 2), loop=True, steps=3, step0=0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    jobs = list(CASES.values()) + [LOOP]
    trees = [seeded_params(lm_cfg(j, ref=True)) for j in jobs]
    with start_reference(jobs, tmp_path_factory.mktemp("ref")) as ref:
        port = spawn_port(port_train, (jobs, trees),
                          tmp_path_factory.mktemp("port"))
        ref = ref.result()
    return dict(zip(list(CASES) + ["loop"], zip(jobs, port, ref)))


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_step_metrics_equal_the_reference(trained, name):
    _, port, ref = trained[name]
    assert len(port["metrics"]) == len(ref["metrics"]) == 2
    for tm, rm in zip(port["metrics"], ref["metrics"]):
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert _rel(tm[k], rm[k]) <= RTOL, (k, tm[k], rm[k])


@pytest.mark.parametrize("name", list(CASES) + ["loop"])
def test_params_and_state_equal_the_reference(trained, name):
    _, port, ref = trained[name]
    for what in ("params", "opt"):
        assert [p for p, _ in port[what]] == [p for p, _ in ref[what]]
        for (path, a), (_, b) in zip(port[what], ref[what]):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert _l2(a, b) <= RTOL, (what, path, _l2(a, b))


def test_loop_history_equals_the_reference(trained):
    _, port, ref = trained["loop"]
    assert len(port["history"]) == 3
    for a, b in zip(port["history"], ref["history"]):
        assert _rel(a, b) <= RTOL, (a, b)


def test_embedding_is_laid_out_as_the_reference(trained):
    """``("vocab", "fsdp")`` -> vocab rows on the model dim, D on the data
    dim: the reference's ``PartitionSpec('model', 'data')``."""
    _, port, ref = trained["qwen-2x2"]
    assert ref["embed_spec"] == "('model', 'data')"
    assert port["embed_layout"] == ["S(1)", "S(0)"]


def test_adafactor_moments_are_factored_and_sharded(trained):
    """Nemotron's 128 x 128 matrices keep (vr, vc), not a full v."""
    _, port, _ = trained["nemotron-adafactor"]
    keys = [p for p, _ in port["opt"]]
    assert any(k.endswith("['vr']") for k in keys)
    assert any(k.endswith("['vc']") for k in keys)
