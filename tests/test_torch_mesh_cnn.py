"""``shard_fc`` over a four-rank ``("model",)`` mesh: the port's
`ReplicaGroup` against the reference's and against one device, on the CPU.

ResNet-18 at 32 px, density 0.5, f32 and int8, on two heads: a
1000-class head (8 strips of 128, two a rank) and a 10-class head (one
strip, which does not divide four ways and stays whole on every rank,
as the reference demotes it).  The reference's `ReplicaGroup(shard_fc=
True)` runs over its four host devices (`_torch_mesh_ref`), the port's
over four gloo ranks; each rank runs its own strips and the logits are
gathered.  A column is computed by one rank alone, so the port's logits
are its one-device `net_apply` logits bit for bit, and int8 is the
reference's bit for bit; f32 is the reference's within 1e-5 relative
(bit for bit on the 1000-class head; the 10-class head's whole-rank
product differs from the reference's jnp path by 4.5e-8, mesh or no
mesh).
"""
import numpy as np
import pytest

from _torch_mesh_ref import cnn_params, port_cnn, run_reference, spawn_port
from _torch_threads import one_torch_thread  # noqa: F401

CASES = {f"{c}-{d or 'f32'}": dict(kind="cnn", classes=c, dtype=d,
                                   density=0.5, seed=0)
         for c in (1000, 10) for d in (None, "int8")}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jobs = [dict(j, images=images.tolist()) for j in CASES.values()]
    trees = [cnn_params(j) for j in jobs]
    port = spawn_port(port_cnn, (jobs, trees),
                      tmp_path_factory.mktemp("port"))
    ref = run_reference(jobs, tmp_path_factory.mktemp("ref"))
    return dict(zip(CASES, zip(jobs, port, ref)))


@pytest.mark.parametrize("name", list(CASES))
def test_logits_equal_one_device(served, name):
    _, port, _ = served[name]
    assert port["logits"].shape == (4, CASES[name]["classes"])
    np.testing.assert_array_equal(port["logits"], port["one"])


@pytest.mark.parametrize("name", list(CASES))
def test_logits_equal_the_reference(served, name):
    job, port, ref = served[name]
    if job["dtype"] == "int8" or job["classes"] == 1000:
        np.testing.assert_array_equal(port["logits"], ref["logits"])
    err = np.abs(port["logits"] - ref["logits"]).max() / \
        np.abs(ref["logits"]).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("name", list(CASES))
def test_strips_shard_where_they_divide(served, name):
    """The head's strips: two a rank where 8 divide over 4, all on every
    rank where one does not (the reference's spec demotes alike)."""
    job, port, ref = served[name]
    assert port["mesh"] == {"model": 4}
    nb = port["fc_local"]["fc"][0]
    if job["classes"] == 1000:
        assert nb == 2 and ref["fc_specs"]["fc"][0] == "model"
    else:
        assert nb == 1 and ref["fc_specs"]["fc"][0] is None
