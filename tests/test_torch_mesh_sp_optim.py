"""``sp`` attention where the heads do not divide the model dim, and
`optim.adamw8bit` on DTensor leaves: the port against the reference
under a mesh, on the CPU.

One reference subprocess (`_torch_mesh_train_ref`, four host devices on
Auto meshes) and one spawn of four gloo ranks run every case.

* ``sp`` with heads that stay whole: reduced Qwen1.5-4B with 6 heads and
  2 KV heads (d_model 192) on a 1x4 mesh, where `sharding.spec_for`
  demotes the heads.  Each ``model`` rank projects q, k and v only for
  its block of the sequence and gathers k and v (not every head over
  the whole sequence).  The reference's sharded `Server` and the port's
  serve the same traffic: greedy streams, steps and backfills equal,
  prefill logits within 1e-5; one `build_train` step each from step
  100: loss, ce, aux and grad norm within 1e-5, every param and
  optimizer-state leaf within 1e-5 relative in the L2 norm.  Where the
  heads divide (4 heads on 2x2 or 1x4) the projections keep the whole
  sequence, as before: the same code path, op for op.
* ``adamw8bit`` on a 2x2 mesh: the reduced Qwen's params laid out by
  the schema, three updates by seeded gradients at lr 1e-3 against the
  reference's ``update`` with `param_shardings`, run op by op on the
  sharded arrays (jitted, XLA turns its division of the block amax by
  127 into a multiply by the f32 reciprocal: 5% of the scales move by
  an ulp, and a code in 65536 by one; the port divides, as the
  reference's source and its eager ops do).  Moments
  replicated (``state_axes``), blocks over the whole leaf: codes and
  scales equal, params within 1e-5 relative (L2), each step's
  ``p_new - p_old`` within 1e-5 relative (L2); the mesh run bit-equal
  to the port's mesh-free one.
"""
import dataclasses

import numpy as np
import pytest

from _torch_lm_params import seeded_params
from _torch_mesh_ref import lm_jobs, spawn_port
from _torch_mesh_train_ref import (adam_job, lm_cfg, port_jobs,
                                   start_reference, train_job)
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.launch import step_builders as sb
from repro_torch.models import attention as TA
from repro_torch.optim.optimizers import adamw8bit
from repro_torch.parallel import sharding as shd

RTOL = 1e-5
NONDIV = {"n_heads": 6, "n_kv_heads": 2, "d_model": 192}
SERVE = lm_jobs([("qwen1.5-4b", NONDIV, (1, 4))])[0]
TRAIN = train_job("qwen1.5-4b", (1, 4), overrides=NONDIV, steps=1)
ADAM = adam_job("qwen1.5-4b", (2, 2))


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    jobs = [SERVE, TRAIN, ADAM]
    trees = [seeded_params(lm_cfg(j, ref=True)) for j in jobs]
    with start_reference(jobs, tmp_path_factory.mktemp("ref")) as ref:
        port = spawn_port(port_jobs, (jobs, trees),
                          tmp_path_factory.mktemp("port"))
        ref = ref.result()
    return dict(zip(("serve", "train", "adam"), zip(port, ref)))


def _l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("shape,heads,want", [
    ((1, 4), 6, "seq_sp"), ((2, 2), 6, "seq"), ((1, 4), 4, "seq"),
    ((2, 2), 4, "seq"), ((4, 1), 6, "seq"), ((16, 16), 20, "seq_sp")])
def test_projections_take_the_sequence_block_only_where_heads_stay_whole(
        shape, heads, want):
    """20 heads on a model dim of 16 (Qwen1.5-4B on the pod) stay whole,
    so the projections take the rank's block of the sequence; 6 heads
    divide a model dim of 2 (and of 1), so they keep the whole
    sequence and split the heads."""
    cfg = dataclasses.replace(get_config("qwen1.5-4b").reduce(),
                              n_heads=heads, n_kv_heads=2, d_model=32 * 6)
    mesh = shd.AbstractMesh(shape, ("data", "model"))
    with shd.use_mesh(mesh, shd.TRAIN_RULES):
        assert TA._project_seq_axis(cfg) == want
        assert TA._project_seq_axis(dataclasses.replace(
            cfg, attn_sharding="heads")) == "seq"


def test_sp_serve_equals_the_reference(ran):
    port, ref = ran["serve"]
    assert port["streams"] == ref["streams"]
    assert port["steps"] == ref["steps"]
    assert port["backfills"] == ref["backfills"]
    got, want = port["prefill_logits"], ref["prefill_logits"]
    assert got.shape == want.shape == (4, 512)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL, err


def test_sp_train_step_equals_the_reference(ran):
    port, ref = ran["train"]
    for tm, rm in zip(port["metrics"], ref["metrics"]):
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert _rel(tm[k], rm[k]) <= RTOL, (k, tm[k], rm[k])
    for what in ("params", "opt"):
        assert [p for p, _ in port[what]] == [p for p, _ in ref[what]]
        for (path, a), (_, b) in zip(port[what], ref[what]):
            assert _l2(a, b) <= RTOL, (what, path, _l2(a, b))


def test_adamw8bit_codes_and_scales_equal_the_reference(ran):
    port, ref = ran["adam"]
    assert [p for p, _ in port["opt"]] == [p for p, _ in ref["opt"]]
    n = 0
    for (path, a), (_, b) in zip(port["opt"], ref["opt"]):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
        n += path.endswith("['mq']")
    assert n == len(port["params"])


def test_adamw8bit_params_and_updates_equal_the_reference(ran):
    port, ref = ran["adam"]
    for (path, a), (_, b) in zip(port["params"], ref["params"]):
        assert _l2(a, b) <= RTOL, (path, _l2(a, b))
    assert len(port["deltas"]) == len(ref["deltas"]) == ADAM["steps"]
    for step, (got, want) in enumerate(zip(port["deltas"], ref["deltas"])):
        for i, (a, b) in enumerate(zip(got, want)):
            assert _l2(a, b) <= RTOL, (step, i, _l2(a, b))


def test_adamw8bit_on_the_mesh_equals_mesh_free(ran):
    port, _ = ran["adam"]
    free = port["mesh_free"]
    for what in ("params", "opt"):
        for (path, a), (_, b) in zip(port[what], free[what]):
            np.testing.assert_array_equal(a, b, err_msg=path)


def test_adamw8bit_state_axes_replicate_and_make_optimizer_is_unchanged():
    axes = adamw8bit().state_axes(("vocab", "fsdp"), (512, 128))
    assert axes == {"mq": (None, None), "ms": (None,), "vq": (None, None),
                    "vs": (None,)}
    cfg = get_config("qwen1.5-4b").reduce()
    assert sb.make_optimizer(cfg).state_axes is None          # AdamW
    assert sb.make_optimizer(dataclasses.replace(
        cfg, optimizer="adafactor")).state_axes is not None
