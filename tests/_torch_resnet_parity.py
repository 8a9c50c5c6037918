"""The shared body of the ResNet-34 and ResNet-50 parity tests
(`test_torch_resnet34.py`, `test_torch_resnet50.py`), on the CPU.

The reduced config (32 px, 200 classes: the FC remainder strip stays),
batch 2.  The weights are made with numpy from a seed for the reference's
schema and handed to both sides through the weights bridge.  Each
reference forward is one jitted ``impl="jnp"`` forward, made once per
(density, dtype) and test module.

Tolerances: encodings byte for byte; f32 logits to a relative 1e-5 of
max|y| (only the order of the f32 sums differs); int8 logits bit for bit
(power-of-two scales and exact integer partials on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from numpy.testing import assert_array_equal

from repro.models import graph as jg
from repro_torch.launch.serve import CNNServer, ImageRequest
from repro_torch.models import graph as tg
from repro_torch.params import params_from_numpy, sparse_from_numpy

RTOL = 1e-5
DENSITIES = (0.235, 1.0)


def assert_close(y, ref, rtol=RTOL):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    assert y.shape == ref.shape
    err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, err


def weights(jnet) -> dict:
    """A numpy tree for the reference's schema: normal weights at
    fan_in^-1/2, BN statistics and biases drawn around their identity so
    that folding them changes the weights."""
    rng = np.random.default_rng(0)
    tree = {}
    for name, leaves in jnet.schema().items():
        tree[name] = {}
        for leaf, p in leaves.items():
            if p.init == "normal":
                v = rng.standard_normal(p.shape) * p.fan_in ** -0.5
            elif leaf in ("scale", "var"):
                v = rng.uniform(0.5, 1.5, p.shape)
            else:
                v = rng.normal(0, 0.1, p.shape)
            tree[name][leaf] = v.astype(np.float32)
    return tree


def images(n: int = 2, size: int = 32) -> np.ndarray:
    return np.random.default_rng(1).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def reference(jnet, tree: dict, x: np.ndarray):
    """(density, dtype) -> (the reference's sparse tree, its jitted
    ``impl="jnp"`` logits), each made once."""
    jparams = jax.tree.map(jnp.asarray, tree)
    cache: dict = {}

    def get(density, dtype=None):
        key = (density, dtype)
        if key not in cache:
            jsparse, _ = jg.sparsify(jnet, jparams, density, dtype=dtype)
            logits = jax.jit(lambda w, xx: jg.net_apply(
                jnet, w, xx, sparse=jsparse, impl="jnp"))(
                    jparams, jnp.asarray(x))
            cache[key] = jsparse, np.asarray(logits)
        return cache[key]

    return get


def check_config(cfg, small, jcfg) -> None:
    for f in ("name", "modality", "image_size", "num_classes",
              "weight_density", "vk", "vn", "fixed_image_size"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
        assert getattr(small, f) == getattr(jcfg.reduce(), f), f
    assert (small.image_size, small.num_classes) == (32, 200)
    assert not cfg.fixed_image_size


def check_builder(jnet, tnet, full_t, full_j) -> None:
    """Layer lists field for field and schemas leaf for leaf, at the
    reduced and the full size."""
    for j, t in ((jnet, tnet), (full_j, full_t)):
        assert t.name == j.name
        assert len(t.layers) == len(j.layers)
        for a, b in zip(t.layers, j.layers):
            assert type(a).__name__ == type(b).__name__
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        js, ts = j.schema(), t.schema()
        assert list(ts) == list(js)
        for name in js:
            assert {k: (tuple(p.shape), p.init, p.fan_in)
                    for k, p in ts[name].items()} == \
                {k: (tuple(p.shape), p.init, p.fan_in)
                 for k, p in js[name].items()}


def check_encoding(tnet, tree, ref, density, dtype) -> None:
    jsparse, _ = ref(density, dtype)
    tsparse, _ = tg.sparsify(tnet, params_from_numpy(tree, "cpu"), density,
                             dtype=dtype)
    assert list(tsparse) == list(jsparse)
    for name, j in jsparse.items():
        t = tsparse[name]
        assert t.vs.vals.numpy().tobytes() == np.asarray(j.vs.vals).tobytes()
        assert t.vs.idx.numpy().tobytes() == np.asarray(j.vs.idx).tobytes()
        assert t.bias.numpy().tobytes() == np.asarray(j.bias).tobytes()
        assert t.vs.shape == tuple(j.vs.shape)
        if dtype == "int8":
            assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        else:
            assert t.scale is None and j.scale is None


def check_logits(tnet, tree, x, ref, density, dtype) -> None:
    """Port ``impl="plain"``, ``"pallas"`` and ``"pallas-stack"`` (the
    kernels' plain versions over both layouts on the CPU) with its own
    sparse tree, and the bridged reference tree, vs the reference's
    ``impl="jnp"``: f32 within 1e-5, int8 bit for bit."""
    jsparse, want = ref(density, dtype)
    tparams = params_from_numpy(tree, "cpu")
    tsparse, _ = tg.sparsify(tnet, tparams, density, dtype=dtype)
    xt = torch.from_numpy(x)
    outs = [tg.net_apply(tnet, tparams, xt, sparse=tsparse, impl=impl)
            for impl in ("plain", "pallas", "pallas-stack")]
    outs.append(tg.net_apply(tnet, tparams, xt, impl="plain",
                             sparse=sparse_from_numpy(jsparse, "cpu")))
    for y in outs:
        assert y.shape == want.shape == (len(x), 200)
        if dtype == "int8":
            assert_array_equal(y.numpy(), want)
        else:
            assert_close(y, want)


def check_server(small, dtype) -> None:
    """Seven requests at batch 4: a full wave and a backfilled partial
    one; every delivered logit equal to `net_apply` on the same wave."""
    srv = CNNServer(small, batch=4, seed=0, dtype=dtype, device="cpu")
    ims = list(images(7))
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(ims)]
    stats = srv.serve(reqs)
    assert sum(s["images"] for s in stats) == 7
    with torch.inference_mode():
        want = torch.cat([tg.net_apply(
            srv.net, srv.params, torch.from_numpy(np.stack(ims[a:b])),
            sparse=srv.sparse, impl="plain") for a, b in ((0, 4), (4, 7))
        ]).numpy()
    got = np.stack([r.logits for r in reqs])
    assert all(r.outcome.status == "delivered" for r in reqs)
    assert_array_equal(got, want)


def check_served_on_card(small, dtype, per_forward: dict) -> None:
    """On the card: 6 requests at batch 4 (a wave of 4, then a wave of 2
    in its own bucket), every wave a graph replay; logits bit-equal to
    eager `net_apply` with the served impl, f32 within 1e-5 of the plain
    path and int8 bit-equal; launches exactly per forward x (waves +
    graphs), every one an int8 launch on the int8 path."""
    from repro_torch.kernels.capture import add_counts, counts, wrappers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    srv = CNNServer(small, batch=4, seed=0, dtype=dtype, device="cuda")
    ims = list(images(6))
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(ims)]
    add_counts({k: -n for k, n in counts().items()})
    stats = srv.serve(reqs)
    torch.cuda.synchronize()
    kernels = wrappers()
    launches = {n: k.launches for n, k in kernels.items() if k.launches}
    waves = sum(s["steps"] for s in stats)
    apply = srv.backend.apply
    assert (waves, apply.compiles, apply.replays) == (2, 2, 2)
    assert launches == {k: v * (waves + apply.compiles)
                        for k, v in per_forward.items()}
    int8 = {n: k.int8_launches for n, k in kernels.items()
            if getattr(k, "int8_launches", 0)}
    assert int8 == (launches if dtype == "int8" else {})
    got = np.stack([r.logits for r in reqs])
    with torch.inference_mode():
        def direct(impl):
            return torch.cat([tg.net_apply(
                srv.net, srv.params,
                torch.from_numpy(np.stack(ims[a:b])).cuda(),
                sparse=srv.sparse, impl=impl).cpu()
                for a, b in ((0, 4), (4, 6))]).numpy()
        assert_array_equal(got, direct(apply.impl))
        plain = direct("plain")
    if dtype == "int8":
        assert_array_equal(got, plain)
    else:
        assert_close(got, plain)
