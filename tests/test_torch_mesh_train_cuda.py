"""Training under a mesh on the card: a one-rank NCCL world against the
mesh-free step, the flash kernel at the rank-local training shapes of a
2x2 mesh, and compression and the pipeline on one rank.

Marked ``gpu``: each test asks the ``world`` or ``cuda`` fixture for the
card and skips where there is none.  The file imports no JAX (the CPU
counterparts, held to the reference, are `test_torch_mesh_train.py`,
`test_torch_mesh_train_archs.py`, `test_torch_compression.py` and
`test_torch_pipeline.py`).  The world (`launch.mesh.init_process_group`,
NCCL, a ``file://`` store under the test's temporary directory) is
started once for the module and torn down at its end.

* Reduced Qwen1.5-4B (f32, bf16, and bf16 with 2 microbatches),
  Granite-MoE, RWKV-6, Jamba, HuBERT and Nemotron-4 (Adafactor): two
  steps from step 100 under the 1x1 mesh equal the mesh-free steps bit
  for bit (loss, ce, aux, grad norm, every param and state leaf), with
  the same flash launches.
* `FlashFwd` at the rank-local shapes of Qwen1.5-4B training on a 2x2
  mesh (8 x 512, 4 microbatches: ``sp`` a rank's 256 queries at
  ``q_offset`` 0 and 256 against 512 keys, BH 20; ``heads`` BH 10 over
  512) in bf16: the kernel forward within 1e-2 of the plain one, dq /
  dk / dv within 2e-2 of autograd through the plain one.
* `compressed_psum` on one rank: the sum, the new error, the codes and
  the scales (the amax over 448, a true division on both devices)
  bit-equal to the same computed on the CPU;
  `pipeline_apply` over a pod dim of one rank equals the sequential
  stage, gradients included.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu

STEP0 = 100


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


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _train(cfg, dev, ctx):
    """Two steps from STEP0 of the port's seeded init on ``dev``, under
    ``ctx`` (None: mesh-free) -> (metrics, leaves, flash launches)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import (LMBatchSpec, SyntheticEmbeds,
                                           SyntheticLM)
    from repro_torch.kernels import flash as TF
    from repro_torch.launch import step_builders as sb
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import init_params
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils.tree import leaves

    params = init_params(tfm.lm_schema(cfg), 0, dtype=cfg.dtype, device=dev)
    if ctx is not None:
        with shd.use_mesh(ctx.mesh, ctx.rules):
            params = tfm.shard_params(params, cfg)
    state = sb.init_opt_state(cfg, params, ctx)
    step = sb.build_train(cfg, ShapeSpec("t", 32, 4, "train"), ctx)
    spec = LMBatchSpec(global_batch=4, seq_len=32, vocab=cfg.vocab)
    data = SyntheticLM(spec, 0) if cfg.embed_inputs else \
        SyntheticEmbeds(spec, cfg.d_model, 0)
    metrics = []
    n0 = TF.flash_fwd_kernel.launches
    for i in range(2):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(STEP0 + i).items()}
        if ctx is not None:
            b = sb.shard_batch(cfg, b, ctx)
        params, state, m = step(params, state, b, STEP0 + i)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    launches = TF.flash_fwd_kernel.launches - n0
    out = [x.to_local() if hasattr(x, "to_local") else x
           for x in leaves(params) + leaves(state)]
    return metrics, out, launches


CASES = {
    "qwen-f32": ("qwen1.5-4b", {}),
    "qwen-bf16": ("qwen1.5-4b", {"param_dtype": "bfloat16"}),
    "qwen-bf16-mb2": ("qwen1.5-4b", {"param_dtype": "bfloat16",
                                     "microbatches": 2}),
    "granite-moe": ("granite-moe-3b-a800m", {}),
    "rwkv6": ("rwkv6-3b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "hubert": ("hubert-xlarge", {}),
    "nemotron-adafactor": ("nemotron-4-340b", {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_1x1_mesh_trains_bit_equal_to_mesh_free(world, name):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import sharding as shd

    arch, over = CASES[name]
    cfg = dataclasses.replace(get_config(arch).reduce(), **over)
    free = _train(cfg, world, None)
    ctx = shd.MeshContext(make_local_mesh(1, 1), shd.TRAIN_RULES)
    mesh = _train(cfg, world, ctx)
    assert mesh[0] == free[0]
    assert len(mesh[1]) == len(free[1])
    for a, b in zip(mesh[1], free[1]):
        assert torch.equal(a, b)
    assert mesh[2] == free[2]
    if any(sp.mixer == "attn" for seg in cfg.segments for sp in seg.layers):
        assert free[2] > 0


# (name, BH, Tq, Tk, q_offset, causal) at Qwen1.5-4B's 2x2 training shard
FLASH = [("sp-q0", 20, 256, 512, 0), ("sp-q256", 20, 256, 512, 256),
         ("heads", 10, 512, 512, 0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("case", FLASH, ids=[c[0] for c in FLASH])
def test_flash_at_the_rank_local_training_shapes(cuda, case):
    from repro_torch.kernels import flash as TF
    _, bh, tq, tk, off = case
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=g).to(cuda, torch.bfloat16)
                   for s in ((bh, tq, 128), (bh, tk, 128), (bh, tk, 128),
                             (bh, tq, 128)))
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    n0 = TF.flash_fwd_kernel.launches
    out = TF.flash_fwd_trainable(qs, ks, vs, causal=True, q_offset=off)
    dq, dk, dv = torch.autograd.grad(out, (qs, ks, vs), do)
    assert TF.flash_fwd_kernel.launches == n0 + 1
    qp, kp, vp = (t.float().requires_grad_() for t in (q, k, v))
    ref = TF.flash_fwd_plain(qp, kp, vp, causal=True, q_offset=off)
    rq, rk, rv = torch.autograd.grad(ref, (qp, kp, vp), do.float())
    assert _rel(out, ref) <= 1e-2
    for got, want in ((dq, rq), (dk, rk), (dv, rv)):
        assert _rel(got, want) <= 2e-2


def test_compressed_psum_on_one_rank(world):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import compression as C
    from repro_torch.parallel import sharding as shd
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
    x = torch.randn(3, 700, generator=torch.Generator().manual_seed(1))
    err = 1e-3 * torch.randn(3, 700, generator=torch.Generator().manual_seed(2))
    xd, ed = x.to(world), err.to(world)
    with shd.use_mesh(mesh):
        tot, new = C.compressed_psum(xd, "pod", ed)
    qd, sd, _ = C.quantize_fp8_block(xd + ed)
    q, s, pad = C.quantize_fp8_block(x + err)
    own = C.dequantize_fp8_block(q, s, pad, (3, 700))   # on the CPU
    assert torch.equal(tot.cpu(), own)
    assert torch.equal(new.cpu(), (x + err) - own)
    assert torch.equal(qd.view(torch.uint8).cpu(), q.view(torch.uint8))
    assert torch.equal(sd.cpu(), s)


def test_pipeline_on_one_rank(world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.pipeline import pipeline_apply
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
    g = torch.Generator().manual_seed(3)
    w = (torch.randn(1, 16, 16, generator=g) / 4).to(world)
    b = (0.1 * torch.randn(1, 16, generator=g)).to(world)
    x = torch.randn(6, 3, 16, generator=g).to(world)
    params = {"w": shd.place(w, mesh, (Shard(0),)).requires_grad_(),
              "b": shd.place(b, mesh, (Shard(0),)).requires_grad_()}
    xs = shd.place(x, mesh, (Replicate(),)).requires_grad_()
    y = pipeline_apply(mesh, lambda sp, xi: torch.tanh(xi @ sp["w"] +
                                                       sp["b"]),
                       params, xs)
    gw, gx = torch.autograd.grad((y ** 2).sum(), [params["w"], xs])
    wt, xt = w.clone().requires_grad_(), x.clone().requires_grad_()
    ref = torch.tanh(xt @ wt[0] + b[0])
    rw, rx = torch.autograd.grad((ref ** 2).sum(), [wt, xt])
    assert _rel(y.full_tensor(), ref) <= 1e-6
    assert _rel(gw.full_tensor(), rw) <= 1e-6
    assert _rel(gx.full_tensor(), rx) <= 1e-6
