"""The mesh on the card: a one-rank NCCL world against the mesh-free
paths, and the mesh's rank-local kernel shapes against the plain
versions.

Marked ``gpu``: each test asks the ``world`` or ``cuda`` fixture for the
card and skips where there is none.  The world (`launch.mesh.
init_process_group`, NCCL, a ``file://`` store under the test's
temporary directory) is started once for the module and torn down at
its end.

* Reduced Qwen1.5-4B, Granite-MoE (both dispatches) and Jamba in bf16,
  and ResNet-18 f32 and int8 with ``shard_fc``: under the 1x1 mesh
  (``("model",)`` for the CNN) the served streams and logits are the
  mesh-free ones bit for bit, with the same launches; the decode step
  is one graph replayed a step.
* The sparse-FFN Qwen (tp_hint 2, bf16): the 1x1 mesh merges a rank's
  shard CSRs into one, which at one rank is the mesh-free merge, so the
  logits are bit-equal too.
* Flash at an ``sp`` rank's query slice (``q_offset``) and a ``heads``
  rank's heads, and vsmm at a rank's strips (f32, int8, bf16), each
  against its plain version: f32 within 1e-5, bf16 within 1e-2, int8
  bit for bit.
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
    assert dist.get_backend() == "nccl"
    yield dev
    dist.destroy_process_group()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _counts():
    from repro_torch.kernels.capture import counts
    return {(w.__name__, n): v for (w, n), v in counts().items()}


def _serve(srv, traffic):
    from repro_torch.launch.serve import Request
    reqs = [Request(rid=r, prompt=p, max_new=m) for r, p, m in traffic]
    before = _counts()
    stats = srv.serve(reqs)
    torch.cuda.synchronize()
    after = _counts()
    return ([r.out for r in reqs], stats,
            {k: after[k] - before[k] for k in after if after[k] != before[k]})


def _traffic(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, int(rng.integers(18, 31)),
                             dtype=np.int32), int(rng.integers(3, 10)))
            for i in range(n)]


LM_CASES = {
    "qwen": ("qwen1.5-4b", {}),
    "granite-gather": ("granite-moe-3b-a800m", {}),
    "granite-resident": ("granite-moe-3b-a800m",
                         {"moe_dispatch": "resident"}),
    "jamba": ("jamba-v0.1-52b", {}),
    "qwen-sparse-ffn": ("qwen1.5-4b", {"use_sparse_ffn": True,
                                       "tp_hint": 2}),
}


@pytest.mark.parametrize("name", list(LM_CASES))
def test_one_rank_mesh_serves_the_mesh_free_bits(world, name):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import init_params
    from repro_torch.parallel import sharding as shd

    arch, change = LM_CASES[name]
    cfg = dataclasses.replace(get_config(arch).reduce(), **change,
                              param_dtype="bfloat16",
                              cache_dtype_str="bfloat16")
    raw = init_params(tfm.lm_schema(cfg), 0, dtype=cfg.dtype, device=world)
    mesh = make_local_mesh()
    srv0 = Server(cfg, batch=4, capacity=64, params=raw, device=world)
    srv1 = Server(cfg, batch=4, capacity=64, params=raw, device=world,
                  mesh=mesh)
    traffic = _traffic(cfg.vocab)
    s0, st0, c0 = _serve(srv0, traffic)
    s1, st1, c1 = _serve(srv1, traffic)
    assert s1 == s0
    assert c1 == c0
    assert [s["decode_steps"] for s in st1] == [s["decode_steps"]
                                                for s in st0]
    assert list(srv1.backend.graphs) == [(4, 64)]
    toks = torch.randint(0, cfg.vocab, (4, 32), device=world)
    y0, _ = tfm.prefill(srv0.params, {"tokens": toks}, cfg, capacity=64)
    with shd.use_mesh(mesh, shd.SERVE_RULES):
        y1, _ = tfm.prefill(srv1.params, {"tokens": shd.distribute(
            toks, ("batch", None))}, cfg, capacity=64)
        y1 = y1.full_tensor()
    assert torch.equal(y1, y0)


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_one_rank_shard_fc_is_the_one_device_serve(world, dtype):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CNNServer, ImageRequest
    from torch.distributed.tensor import DTensor

    cfg = get_config("vscnn-resnet18").reduce()
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((32, 32, 3)).astype(np.float32)
              for _ in range(6)]
    out = []
    for shard_fc in (False, True):
        srv = CNNServer(cfg, batch=4, dtype=dtype, seed=0,
                        shard_fc=shard_fc, device=world)
        if shard_fc:
            fc = srv.group.backends[0].apply.sparse["fc"]
            assert isinstance(fc.vs.vals, DTensor)
        reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(images)]
        before = _counts()
        srv.serve(reqs)
        torch.cuda.synchronize()
        after = _counts()
        out.append((np.stack([r.logits for r in reqs]),
                    {k: after[k] - before[k] for k in after}))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_an_sp_rank_slice(cuda, rank, dtype):
    """A rank of a 4-way ``sp`` split: its T/4 queries at q_offset
    rank x T/4 against all T keys, kernel against plain."""
    from repro_torch.kernels.flash import flash_fwd_kernel, flash_fwd_plain
    gen = torch.Generator().manual_seed(rank)
    q = torch.randn(12, 64, 64, generator=gen).to(cuda, dtype)
    k, v = (torch.randn(12, 256, 64, generator=gen).to(cuda, dtype)
            for _ in range(2))
    kw = dict(causal=True, window=None, q_offset=64 * rank)
    y = flash_fwd_kernel(q, k, v, **kw)
    ref = flash_fwd_plain(q, k, v, **kw)
    assert _rel(y, ref) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("window", [None, 48])
def test_flash_at_a_heads_rank(cuda, window):
    from repro_torch.kernels.flash import flash_fwd_kernel, flash_fwd_plain
    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(8, 200, 240, generator=gen).to(
        cuda, torch.bfloat16) for _ in range(3))
    kw = dict(causal=True, window=window, q_offset=0)
    assert _rel(flash_fwd_kernel(q, k, v, **kw),
                flash_fwd_plain(q, k, v, **kw)) <= 1e-2


@pytest.mark.parametrize("dtype", ["f32", "int8", "bf16"])
def test_vsmm_at_a_rank_of_strips(cuda, dtype):
    """A rank's quarter of a head's strips (f32, int8) and of an FFN's
    ``wi`` strips (bf16, f32 out), kernel against plain."""
    from repro_torch.core.vector_sparse import VectorSparse
    from repro_torch.kernels.vsmm import vsmm_kernel, vsmm_plain
    gen = torch.Generator().manual_seed(3)
    nb, s_steps, vk, vn, kb = 8 // 4, 12, 32, 128, 16
    idx = torch.stack([torch.randperm(kb, generator=gen)[:s_steps].sort()
                       .values for _ in range(nb)]).to(torch.int32)
    x = torch.relu(torch.randn(8, kb * vk, generator=gen))
    vals = torch.randn(nb, s_steps, vk, vn, generator=gen)
    kw = {}
    if dtype == "int8":
        x = torch.clamp((x * 20).round(), -127, 127).to(torch.int8)
        vals = torch.clamp((vals * 40).round(), -127, 127).to(torch.int8)
        kw["scale"] = torch.full((nb * vn,), 2.0 ** -8).to(cuda)
    elif dtype == "bf16":
        x, vals = x.to(torch.bfloat16), vals.to(torch.bfloat16)
        kw["out_dtype"] = torch.float32
    vs = VectorSparse(vals=vals.to(cuda), idx=idx.to(cuda),
                      shape=(kb * vk, nb * vn))
    y = vsmm_kernel(x.to(cuda), vs, **kw)
    ref = vsmm_plain(x.to(cuda), vs, **kw)
    if dtype == "int8":
        assert torch.equal(y, ref)
    else:
        assert _rel(y, ref) <= 1e-5
