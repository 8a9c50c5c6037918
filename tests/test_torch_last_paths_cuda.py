"""The last reference paths on the card: cout-sharded convs and
`optim.adamw8bit` in a one-rank NCCL world, and the chunked remat scans,
against the mesh-free paths and the CPU.

Marked ``gpu``: each test asks the ``world`` or ``cuda`` fixture for the
card and skips where there is none (the world is started once for the
module, as `tests/test_torch_mesh_cuda.py` starts it).

* Reduced ResNet-18 and MobileNetV1, f32 and int8, served by
  `CNNServer(shard_fc=True)` with the ``conv`` rule on ``model`` on the
  ``("model",)`` mesh of one rank: every conv entry a DTensor (run by
  `graph._sharded_conv` through the conv kernels), the logits the
  mesh-free serve's bit for bit, with the same launches.
* `adamw8bit` on a reduced Qwen1.5-4B's params (f32 and bf16), three
  updates: on the 1x1 mesh, mesh-free on the card and on the CPU, the
  codes, scales and params bit-equal (every division is by a tensor,
  every square root correctly rounded).
* Reduced RWKV-6 and Jamba in bf16, one training step at T 32 with
  ``scan_chunk`` 8 (chunks recomputed by `layers._ChunkedScan`) and 32 (the
  plain loop): loss and gradients bit-equal on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the kernels run only on "
                    "the card")
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group
    dev = init_process_group(str(tmp_path_factory.mktemp("nccl") / "store"),
                             rank=0, world_size=1, device="cuda")
    yield dev
    dist.destroy_process_group()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _counts():
    from repro_torch.kernels.capture import counts
    return {(w.__name__, n): v for (w, n), v in counts().items()}


@pytest.mark.parametrize("dtype", [None, "int8"])
@pytest.mark.parametrize("net", ["vscnn-resnet18", "vscnn-mobilenet-v1"])
def test_one_rank_sharded_convs_are_the_one_device_serve(world, net, dtype):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CNNServer, ImageRequest
    from repro_torch.models.graph import SparseConv
    from repro_torch.parallel import sharding as shd
    from torch.distributed.tensor import DTensor

    cfg = get_config(net).reduce()
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((32, 32, 3)).astype(np.float32)
              for _ in range(6)]
    out = []
    for mesh in (False, True):
        srv = CNNServer(cfg, batch=4, dtype=dtype, seed=0, shard_fc=mesh,
                        device=world,
                        rules=shd.SERVE_RULES.replace(conv="model"))
        if mesh:
            convs = [e for e in srv.group.backends[0].apply.sparse.values()
                     if isinstance(e, SparseConv)]
            assert convs and all(isinstance(e.vs.vals, DTensor)
                                 for e in convs)
        reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]
        before = _counts()
        srv.serve(reqs)
        torch.cuda.synchronize()
        after = _counts()
        out.append((np.stack([r.logits for r in reqs]),
                    {k: after[k] - before[k] for k in after}))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw8bit_on_the_mesh_the_card_and_the_cpu(world, dtype):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import init_params
    from repro_torch.optim.optimizers import adamw8bit
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import leaves, tree_map

    cfg = get_config("qwen1.5-4b").reduce()
    host = init_params(tfm.lm_schema(cfg), 0, dtype=getattr(torch, dtype),
                       device="cpu")
    gen = torch.Generator().manual_seed(1)
    grads = [tree_map(lambda p: (0.01 * torch.randn(
        p.shape, generator=gen)).to(p.dtype), host) for _ in range(3)]
    mesh = make_local_mesh(1, 1)

    def run(device, on_mesh):
        def lay(tree):
            tree = tree_map(lambda t: t.to(device, copy=True), tree)
            if not on_mesh:
                return tree
            with shd.use_mesh(mesh, shd.TRAIN_RULES):
                return tfm.shard_params(tree, cfg)
        params = lay(host)
        opt = adamw8bit()
        state = opt.init(params)
        for g in grads:
            opt.update_(lay(g), state, params, 1e-3)
        return [(x.full_tensor() if hasattr(x, "full_tensor") else x).cpu()
                for x in leaves(params) + leaves(state["moments"])]

    want = run(torch.device("cpu"), False)
    for got in (run(world, False), run(world, True)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_chunked_train_step_is_bit_equal_to_the_plain_loop(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch import step_builders as sb
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import init_params

    base = dataclasses.replace(get_config(arch).reduce(),
                               param_dtype="bfloat16")
    params = init_params(tfm.lm_schema(base), 0, dtype=base.dtype,
                         device=cuda)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, base.vocab, (2, 32),
                                              dtype=np.int32)).to(cuda)
             for k in ("tokens", "labels")}
    out = []
    for chunk in (8, 32):
        cfg = dataclasses.replace(base, scan_chunk=chunk)
        loss, _, grads = sb._grads_of(params, batch, cfg)
        out.append([loss] + list(grads))
    for a, b in zip(*out):
        assert torch.equal(a, b)
