"""The port's MoE dispatch under a mesh against the reference's, through
both `Server`s, on the CPU (`_torch_mesh_ref`: the reference on four host
devices with Auto axes, the port in four gloo ranks).

Reduced Granite-MoE, seeded f32 weights, six requests at batch 4, on
three meshes, each with both dispatches:

* 2x2: the reference's own sharded answer, which is not the one-device
  one (its ``gather_weights`` body takes each expert's capacity from the
  rank's local tokens, so two of the six streams differ from a 1x1
  mesh); ``resident`` gathers the tokens and takes capacity from all;
* 4x1 (``data`` only): each rank routes its quarter of the batch, its
  capacity from that quarter;
* 1x4 (``model`` only): the experts split four ways, each rank's first
  expert at ``e0`` = rank x experts / 4, the outputs summed.

On each mesh the reference's answer is the oracle: greedy streams,
decode steps and backfills equal, prefill logits within 1e-5 relative.
"""
import numpy as np
import pytest

from _torch_lm_params import seeded_params
from _torch_mesh_ref import lm_cfg, lm_jobs, port_lm, run_reference, \
    spawn_port
from _torch_threads import one_torch_thread  # noqa: F401

GRANITE = "granite-moe-3b-a800m"
CASES = {
    "gather-2x2": ({}, (2, 2)),
    "gather-4x1": ({}, (4, 1)),
    "gather-1x4": ({}, (1, 4)),
    "resident-2x2": ({"moe_dispatch": "resident"}, (2, 2)),
    "resident-4x1": ({"moe_dispatch": "resident"}, (4, 1)),
    "resident-1x4": ({"moe_dispatch": "resident"}, (1, 4)),
}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jobs = lm_jobs([(GRANITE, o, m) for o, m in CASES.values()])
    trees = [seeded_params(lm_cfg(j)) for j in jobs]
    port = spawn_port(port_lm, (jobs, trees),
                      tmp_path_factory.mktemp("port"))
    ref = run_reference(jobs, tmp_path_factory.mktemp("ref"))
    return dict(zip(CASES, zip(jobs, port, ref)))


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_streams_equal_the_reference(served, name):
    _, port, ref = served[name]
    assert port["streams"] == ref["streams"]


@pytest.mark.parametrize("name", list(CASES))
def test_steps_and_backfills_equal_the_reference(served, name):
    _, port, ref = served[name]
    assert port["steps"] == ref["steps"]
    assert port["backfills"] == ref["backfills"]


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_equal_the_reference(served, name):
    _, port, ref = served[name]
    got, want = port["prefill_logits"], ref["prefill_logits"]
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_local_capacity_changes_the_answer(served):
    """The 2x2 ``gather_weights`` answer is the mesh's own: it differs
    from the ``resident`` one (capacity from every token) in some
    stream, on both sides alike."""
    gather, resident = served["gather-2x2"], served["resident-2x2"]
    assert gather[1]["streams"] != resident[1]["streams"]
    assert gather[2]["streams"] != resident[2]["streams"]
