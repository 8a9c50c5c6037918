"""The port's `Server` under a mesh against the reference's on the
recurrent and windowed archs, on the CPU (`_torch_mesh_ref`: the
reference on four host devices with Auto axes, the port in four gloo
ranks; seeded f32 weights, six requests at batch 4).

* reduced RWKV-6 on 2x2: the head-parallel time mix and the F-parallel
  channel mix, their states sharded by heads;
* reduced Gemma-3 on 2x2 and on 1x4: ``heads`` attention with sliding
  windows, whose circular caches (16 slots) are sequence-sharded over
  the model dim, so a decode step's new row lands on one rank and the
  softmax is combined over two and four ranks.

Greedy streams, decode steps and backfills equal; prefill logits within
1e-5 relative.
"""
import numpy as np
import pytest

from _torch_lm_params import seeded_params
from _torch_mesh_ref import lm_cfg, lm_jobs, port_lm, run_reference, \
    spawn_port
from _torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "rwkv6-2x2": ("rwkv6-3b", {}, (2, 2)),
    "gemma3-2x2": ("gemma3-12b", {}, (2, 2)),
    "gemma3-1x4": ("gemma3-12b", {}, (1, 4)),
}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jobs = lm_jobs(list(CASES.values()))
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


def test_windowed_cache_is_sequence_sharded(served):
    """Gemma-3's first layer (window 16) on 1x4: its 16 cache slots are
    split four ways on the model dim."""
    assert served["gemma3-1x4"][1]["cache_layout"] == ["S(1)", "S(2)"]
