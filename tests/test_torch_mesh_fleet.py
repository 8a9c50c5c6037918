"""CNN serving over several rank groups and with cout-sharded convs: the
port's `ReplicaGroup` against the reference's, on the CPU.

One reference subprocess (`_torch_mesh_ref`, four host devices) and one
spawn of four gloo ranks run every case; both sides start from the
reference's seeded weights at 32 px, density 0.5, 1000-class heads.

* Fleets (``shard_fc=True``): the world laid out as the reference's
  (data, model) grid, one ``("model",)`` group a replica, behind a
  `FleetScheduler` at batch 4 over 16 images.  ResNet-18 as 2 replicas x
  ``model`` 2 and as 4 replicas x ``model`` 1, f32 and int8, and 2 x 2
  f32 under the seeded `FaultPlan` 0 (replica 1 dies at its first
  dispatch, replica 0 at a later one: re-placements, then refusals).
  Every request's logits are bit-equal to the same fleet on one device
  (``shard_fc=False``: the same waves) and to the reference's; each
  request's outcome (status, reason, replica, attempts, wave), the
  runs' stats and the fleet's waves equal the reference's.
* Cout-sharded convs: the serving rules with ``conv`` on ``model`` over
  four ranks, ResNet-18 and MobileNetV1, f32 and int8.  Which entries
  are sharded (their strip counts divide four ways) equals the
  reference's specs; the logits are bit-equal to the port's one-device
  `net_apply` (each column is one rank's), and to the reference for
  int8; f32 within 1e-5 relative of the reference (its jnp path sums in
  another order).  The reference runs with an exact ``jnp.exp2`` of
  whole numbers (`_torch_mesh_ref.exact_exp2`): this jax's misses 2^-13,
  the int8 scale of MobileNetV1's dw5 input, so its "power of two" scale there
  is 1.2207025e-4, and its int8 logits differ from the port's (and from
  its own with the exact power) by up to 4.9e-11 of 4.5e-10.
"""
import numpy as np
import pytest

from _torch_mesh_ref import (cnn_params, port_cnn_jobs, run_reference,
                             spawn_port)
from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
BASE = dict(classes=1000, density=0.5, seed=0)
FLEETS = {
    "2x2-f32": dict(BASE, kind="fleet", replicas=2, dtype=None),
    "2x2-int8": dict(BASE, kind="fleet", replicas=2, dtype="int8"),
    "4x1-f32": dict(BASE, kind="fleet", replicas=4, dtype=None),
    "4x1-int8": dict(BASE, kind="fleet", replicas=4, dtype="int8"),
    "2x2-f32-chaos0": dict(BASE, kind="fleet", replicas=2, dtype=None,
                           chaos=0),
}
CONVS = {f"{net}-{d or 'f32'}": dict(BASE, kind="cnn", conv=True, net=net,
                                     dtype=d)
         for net in ("resnet18", "mobilenet_v1") for d in (None, "int8")}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rng = np.random.default_rng(0)
    fleet_images = rng.standard_normal((16, 32, 32, 3)).astype(np.float32)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jobs = [dict(j, images=fleet_images.tolist(), batch=4)
            for j in FLEETS.values()]
    jobs += [dict(j, images=images.tolist()) for j in CONVS.values()]
    trees = [cnn_params(j) for j in jobs]
    port = spawn_port(port_cnn_jobs, (jobs, trees),
                      tmp_path_factory.mktemp("port"))
    ref = run_reference(jobs, tmp_path_factory.mktemp("ref"))
    return dict(zip(list(FLEETS) + list(CONVS), zip(jobs, port, ref)))


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_grid_is_the_references(served, name):
    job, port, ref = served[name]
    model = 4 // job["replicas"]
    assert port["mesh"] == {"model": model}
    assert ref["meshes"] == [{"model": model}] * job["replicas"]


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_logits_equal_one_device_and_the_reference(served, name):
    _, port, ref = served[name]
    fleet, one = port["fleet"], port["one"]
    assert sorted(fleet["logits"]) == sorted(one["logits"]) == \
        sorted(ref["logits"])
    assert fleet["logits"], "no request was delivered"
    for rid, y in fleet["logits"].items():
        assert y.shape == (1000,)
        np.testing.assert_array_equal(y, one["logits"][rid])
        np.testing.assert_array_equal(y, ref["logits"][rid])


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_outcomes_stats_and_waves_equal_the_reference(served, name):
    job, port, ref = served[name]
    fleet = port["fleet"]
    assert fleet["outcomes"] == ref["outcomes"]
    assert len(fleet["outcomes"]) == len(job["images"])
    assert fleet["stats"] == ref["stats"]
    assert fleet["waves"] == ref["waves"]
    assert port["one"]["outcomes"] == ref["outcomes"]
    replicas = {o[2] for o in fleet["outcomes"].values()
                if o[0] == "delivered"}
    if "chaos" in job:
        statuses = {o[0] for o in fleet["outcomes"].values()}
        assert statuses == {"delivered", "refused"}, fleet["outcomes"]
        assert max(o[3] for o in fleet["outcomes"].values()) > 0
    else:
        assert replicas == set(range(job["replicas"]))


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_strip_specs_equal_the_references(served, name):
    _, port, ref = served[name]
    assert port["specs"] == ref["specs"]
    sharded = {n for n, s in port["specs"].items() if s == "model"}
    whole = set(port["specs"]) - sharded
    convs = {n for n in sharded if n != "fc"}
    assert convs and whole, (sharded, whole)
    if name.startswith("mobilenet"):
        assert any(n.startswith("dw") for n in convs), convs


@pytest.mark.parametrize("name", list(CONVS))
def test_conv_logits_equal_one_device_and_the_reference(served, name):
    job, port, ref = served[name]
    assert port["logits"].shape == (4, 1000)
    np.testing.assert_array_equal(port["logits"], port["one"])
    if job["dtype"] == "int8":
        np.testing.assert_array_equal(port["logits"], ref["logits"])
    err = np.abs(port["logits"] - ref["logits"]).max() / \
        np.abs(ref["logits"]).max()
    assert err <= RTOL, err
