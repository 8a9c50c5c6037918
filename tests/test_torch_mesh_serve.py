"""The port's LM `Server` under a mesh against the reference's `Server`
under the same mesh, on the CPU.

The reference runs in a subprocess with four host devices on a 2x2
``("data", "model")`` mesh with Auto axes (`_torch_mesh_ref`); the port
in four gloo ranks (`torch.multiprocessing.spawn`, one ``file://``
store), its `Server(mesh=make_local_mesh(2, 2))`.  Both serve the same
seeded f32 weights (`_torch_lm_params.seeded_params`) and six requests
at batch 4 (slots retire and backfill):

* reduced Qwen1.5-4B (``attn_sharding="sp"``: each rank's flash queries
  are its slice of the sequence at ``q_offset``, against the whole K/V);
* reduced Jamba (``"heads"`` attention, the channel-parallel Mamba mixer
  and the MoE);
* the sparse-FFN Qwen with ``tp_hint=2`` (each rank's ``wi`` strips and
  its own ``wo`` CSR, the outputs summed over the model dim).

Greedy streams, decode steps and backfills equal; prefill logits within
1e-5 relative; the K/V cache sequence-sharded over the model dim.
"""
import numpy as np
import pytest

from _torch_lm_params import seeded_params
from _torch_mesh_ref import lm_cfg, lm_jobs, port_lm, run_reference, \
    spawn_port
from _torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "qwen-sp": ("qwen1.5-4b", {}, (2, 2)),
    "jamba-heads-mamba": ("jamba-v0.1-52b", {}, (2, 2)),
    "qwen-sparse-ffn": ("qwen1.5-4b", {"use_sparse_ffn": True,
                                       "tp_hint": 2}, (2, 2)),
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
    job, port, ref = served[name]
    assert port["streams"] == ref["streams"]
    assert [len(s) for s in port["streams"]] == [m for _, _, m in
                                                 job["traffic"]]


@pytest.mark.parametrize("name", list(CASES))
def test_steps_and_backfills_equal_the_reference(served, name):
    _, port, ref = served[name]
    assert port["steps"] == ref["steps"]
    assert port["backfills"] == ref["backfills"]
    assert sum(port["backfills"]) >= 1


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_equal_the_reference(served, name):
    _, port, ref = served[name]
    got, want = port["prefill_logits"], ref["prefill_logits"]
    assert got.shape == want.shape == (4, 512)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_kv_cache_is_sequence_sharded(served):
    """Qwen's persisted K/V: batch on the data dim, slots on the model
    dim (the reference's ``CACHE_AXES``: ``kv_seq`` -> model)."""
    assert served["qwen-sp"][1]["cache_layout"] == ["S(1)", "S(2)"]
