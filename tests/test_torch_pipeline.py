"""The port's GPipe pipeline against the reference's, on the CPU.

Four gloo ranks (`_torch_mesh_ref.spawn_port`) run `pipeline_apply` over
a ``("pod",)`` mesh of four stages, each a tanh-linear layer
(`_torch_mesh_train_ref.pipeline_stage`), the stage weights a DTensor
sharded over ``pod`` and 6 microbatches replicated; the reference runs
its `pipeline_apply` over an Auto ``("pod",)`` mesh of four host
devices (a subprocess).  Forward outputs and the gradients of
``sum(out ** 2)`` in the weights, biases and inputs within 1e-5
(relative to each one's largest value), and both equal to the plain
sequential stack.  The single-stage case (a pod dim of one rank: no
point-to-point call) runs on a 4 x 1 ``("data", "pod")`` mesh against
the reference's one-device mesh.
"""
import numpy as np
import pytest
import torch

from _torch_mesh_ref import spawn_port
from _torch_mesh_train_ref import pipeline_stage, start_reference
from _torch_threads import one_torch_thread  # noqa: F401

M, B, D = 6, 3, 16


def _inputs(stages: int, seed: int):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((stages, D, D)) / np.sqrt(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal((stages, D))).astype(np.float32)
    x = rng.standard_normal((M, B, D)).astype(np.float32)
    return w, b, x


def _port(cases: list) -> list:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.pipeline import pipeline_apply

    out = []
    for stages, w, b, x in cases:
        if stages == 4:
            mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
            st, rep = (Shard(0),), (Replicate(),)
        else:
            mesh = init_device_mesh("cpu", (4, 1),
                                    mesh_dim_names=("data", "pod"))
            st, rep = (Replicate(), Shard(0)), (Replicate(), Replicate())
        params = {"w": shd.place(torch.from_numpy(w), mesh, st),
                  "b": shd.place(torch.from_numpy(b), mesh, st)}
        params = {k: v.requires_grad_() for k, v in params.items()}
        xs = shd.place(torch.from_numpy(x), mesh, rep).requires_grad_()
        y = pipeline_apply(mesh, lambda sp, xi: pipeline_stage(sp, xi, torch),
                           params, xs, pod_axis="pod")
        gw, gb, gx = torch.autograd.grad((y ** 2).sum(),
                                         [params["w"], params["b"], xs])
        with torch.no_grad():
            y_ng = pipeline_apply(
                mesh, lambda sp, xi: pipeline_stage(sp, xi, torch),
                params, xs, pod_axis="pod")
        out.append({"out": y.full_tensor().detach().numpy(),
                    "out_no_grad": y_ng.full_tensor().numpy(),
                    "gw": gw.full_tensor().numpy(),
                    "gb": gb.full_tensor().numpy(),
                    "gx": gx.full_tensor().numpy()})
    return out


def _sequential(w, b, x):
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    h = xt
    for s in range(w.shape[0]):
        h = torch.tanh(h @ wt[s] + bt[s])
    g = torch.autograd.grad((h ** 2).sum(), [wt, bt, xt])
    return {"out": h.detach().numpy(), "gw": g[0].numpy(),
            "gb": g[1].numpy(), "gx": g[2].numpy()}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    cases = [(4, *_inputs(4, 0)), (1, *_inputs(1, 1))]
    jobs = [dict(kind="pipeline", stages=s, w=w.tolist(), b=b.tolist(),
                 x=x.tolist()) for s, w, b, x in cases]
    with start_reference(jobs, tmp_path_factory.mktemp("ref")) as ref:
        port = spawn_port(_port, (cases,), tmp_path_factory.mktemp("port"))
        return cases, port, ref.result()


def _close(a, b, tol=1e-5):
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("case", [0, 1], ids=["4-stages", "1-stage"])
def test_forward_equals_the_reference(both, case):
    _, port, ref = both
    _close(port[case]["out"], ref[case]["out"])
    np.testing.assert_array_equal(port[case]["out"],
                                  port[case]["out_no_grad"])


@pytest.mark.parametrize("case", [0, 1], ids=["4-stages", "1-stage"])
@pytest.mark.parametrize("key", ["gw", "gb", "gx"])
def test_gradients_equal_the_reference(both, case, key):
    _, port, ref = both
    _close(port[case][key], ref[case][key])


@pytest.mark.parametrize("case", [0, 1], ids=["4-stages", "1-stage"])
def test_equals_the_sequential_stack(both, case):
    cases, port, _ = both
    seq = _sequential(*cases[case][1:])
    for key in ("out", "gw", "gb", "gx"):
        _close(port[case][key], seq[key])
