"""The port's training under a mesh against the reference's, on the CPU:
the archs with a MoE or a recurrent mixer.

As `test_torch_mesh_train` (the reference's `build_train` on an Auto 2x2
``("data", "model")`` mesh in a subprocess, the port's in four gloo
ranks, the same seeded f32 weights and pipeline batches, two steps from
step 100), for:

* reduced Granite-MoE-3B: the MoE's aux averaged over the batch dims and
  each rank's capacity from its *local* tokens (the reference's sharded
  dispatch), under grad;
* reduced RWKV-6-3B: the time mix's heads and the channel mix over the
  model dim;
* reduced Jamba-v0.1: the channel-parallel Mamba mixer, ``heads``
  attention and the MoE.

Tolerances: loss, ce, aux and grad norm each step within 1e-5 relative;
each parameter leaf after the last step within 1e-5 relative in the L2
norm.  Each optimizer-state leaf (AdamW's moments: functions of the
gradients) within 1e-5 or, where larger, twice the reference's own
spread when the same steps start from its weights each moved by one f32
ulp (the one-device test's bound on gradients, `test_torch_train_step`).
At these weights RWKV-6's time-mix gradients (as the one-device test
found) and Jamba's Mamba ones are ill-conditioned: their moments
differ from the reference's by more than 1e-5, within twice the
reference's own one-ulp spread.
"""
import numpy as np
import pytest

from _torch_lm_params import seeded_params
from _torch_mesh_ref import spawn_port
from _torch_mesh_train_ref import lm_cfg, port_train, start_reference, \
    state_bound, train_job
from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
CASES = {
    "granite-moe": train_job("granite-moe-3b-a800m", (2, 2), spread=True),
    "rwkv6": train_job("rwkv6-3b", (2, 2), spread=True),
    "jamba": train_job("jamba-v0.1-52b", (2, 2), spread=True),
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    jobs = list(CASES.values())
    trees = [seeded_params(lm_cfg(j, ref=True)) for j in jobs]
    with start_reference(jobs, tmp_path_factory.mktemp("ref")) as ref:
        port = spawn_port(port_train, (jobs, trees),
                          tmp_path_factory.mktemp("port"))
        return dict(zip(CASES, zip(jobs, port, ref.result())))


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("name", list(CASES))
def test_step_metrics_equal_the_reference(trained, name):
    _, port, ref = trained[name]
    for tm, rm in zip(port["metrics"], ref["metrics"]):
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert _rel(tm[k], rm[k]) <= RTOL, (k, tm[k], rm[k])


def _l2(a, b) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_params_equal_the_reference(trained, name):
    _, port, ref = trained[name]
    assert [p for p, _ in port["params"]] == [p for p, _ in ref["params"]]
    for (path, a), (_, b) in zip(port["params"], ref["params"]):
        assert _l2(a, b) <= RTOL, (path, _l2(a, b))


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_state_equals_the_reference(trained, name):
    _, port, ref = trained[name]
    assert [p for p, _ in port["opt"]] == [p for p, _ in ref["opt"]]
    for i, ((path, a), (_, b)) in enumerate(zip(port["opt"], ref["opt"])):
        assert _l2(a, b) <= state_bound(ref, i, RTOL), (
            path, _l2(a, b), ref["opt_ulp_spread"][i])


def test_moe_aux_is_live(trained):
    """Granite's and Jamba's aux is the routers' load-balance loss, not a
    zero that would hide its gradient."""
    for name in ("granite-moe", "jamba"):
        _, port, _ = trained[name]
        assert all(m["aux"] > 0 for m in port["metrics"])
