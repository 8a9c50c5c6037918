"""MobileNetV1 through the port against the JAX reference, on the CPU.

MobileNetV1 at 32 px with a 10-class head, batch 2, randomised BN
statistics (so the BN fold of the depthwise layers is exercised).  The
weights are drawn once by the reference's `init_params`, randomised with
numpy and handed to both sides through the weights bridge.  Each reference
forward is computed once per module (the reference's ``impl="jnp"``
MobileNetV1 forward takes tens of seconds here).

Tolerances: encodings exactly; logits to a relative 1e-5 of max|y| (the
only difference is the order of the f32 sums).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import graph as jg
from repro.models.layers import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.launch.serve import CNNServer, ImageRequest
from repro_torch.models import graph as tg
from repro_torch.params import params_from_numpy, sparse_from_numpy

RTOL = 1e-5
DENSITY = 0.5


def _assert_close(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    assert y.shape == ref.shape
    err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= RTOL, err


@pytest.fixture(scope="module")
def nets():
    return jg.build_mobilenet_v1(10), tg.build_mobilenet_v1(10)


@pytest.fixture(scope="module")
def weights(nets):
    """Reference-initialised MobileNetV1 params as numpy, BN randomised."""
    tree = jax.tree.map(np.asarray, jinit(nets[0].schema(),
                                          jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(0)
    for entry in tree.values():
        if "scale" in entry:
            c = entry["scale"].shape[0]
            entry["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            entry["offset"] = rng.normal(0, 0.1, c).astype(np.float32)
            entry["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            entry["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def reference(nets, weights, images):
    """The reference's sparsify result and logits, each computed once."""
    jparams = jax.tree.map(jnp.asarray, weights)
    cache = {}

    def get(key):
        if key not in cache:
            if key[0] == "sparsify":
                cache[key] = jg.sparsify(nets[0], jparams, key[1])
            else:
                jsparse, _ = get(("sparsify", DENSITY))
                cache[key] = np.asarray(jg.net_apply(
                    nets[0], jparams, jnp.asarray(images), sparse=jsparse,
                    impl=key[1]))
        return cache[key]

    return get


def test_builder_matches_reference(nets):
    jnet, tnet = nets
    assert tnet.name == jnet.name
    assert len(tnet.layers) == len(jnet.layers)
    for t, j in zip(tnet.layers, jnet.layers):
        assert type(t).__name__ == type(j).__name__
        assert dataclasses.asdict(t) == {
            k: v for k, v in dataclasses.asdict(j).items()
            if k in dataclasses.asdict(t)}
    assert tg.MOBILENET_V1_PLAN == jg.MOBILENET_V1_PLAN
    assert tnet.schema().keys() == jnet.schema().keys()


@pytest.mark.parametrize("density", [1.0, DENSITY])
def test_sparsify_reproduces_reference_encoding(nets, weights, reference,
                                                density):
    """Depthwise BN fold, tap-matrix encoding and grouped pruning: byte
    equal to the reference."""
    jsparse, jpruned = reference(("sparsify", density))
    tsparse, tpruned = tg.sparsify(nets[1], params_from_numpy(weights, "cpu"),
                                   density)
    assert tsparse.keys() == jsparse.keys()
    for name, j in jsparse.items():
        t = tsparse[name]
        assert t.vs.vals.numpy().tobytes() == np.asarray(j.vs.vals).tobytes()
        assert t.vs.idx.numpy().tobytes() == np.asarray(j.vs.idx).tobytes()
        assert t.bias.numpy().tobytes() == np.asarray(j.bias).tobytes()
        assert t.vs.shape == tuple(j.vs.shape)
        if isinstance(t, tg.SparseConv):
            assert (t.kh, t.kw, t.stride, t.groups, t.dilation, t.cin_pad) \
                == (j.kh, j.kw, j.stride, j.groups, j.dilation, j.cin_pad)
    for name, entry in jpruned.items():
        for leaf, value in entry.items():
            np.testing.assert_array_equal(tpruned[name][leaf].numpy(),
                                          np.asarray(value))
    dw = tsparse["dw13"]
    assert dw.vs.vk == 1 and dw.vs.shape == (9, 1024) and dw.groups == 1024


def test_logits_match_reference_jnp(nets, weights, images, reference):
    """Port ``impl="plain"`` (own sparse tree and the bridged reference
    tree) vs the reference's ``impl="jnp"``."""
    ref = reference(("logits", "jnp"))
    tparams = params_from_numpy(weights, "cpu")
    tsparse, _ = tg.sparsify(nets[1], tparams, DENSITY)
    x = torch.from_numpy(images)
    y_own = tg.net_apply(nets[1], tparams, x, sparse=tsparse, impl="plain")
    jsparse, _ = reference(("sparsify", DENSITY))
    y_bridged = tg.net_apply(nets[1], tparams, x, impl="plain",
                             sparse=sparse_from_numpy(jsparse, "cpu"))
    assert y_own.shape == (2, 10)
    _assert_close(y_own, ref)
    _assert_close(y_bridged, ref)


def test_stack_logits_match_reference_stack(nets, weights, images,
                                            reference):
    """Port ``impl="pallas-stack"`` on the CPU (the stack kernels' plain
    versions over the row-tap stack) vs the reference's
    ``impl="pallas-stack"`` (its stack Pallas kernels in interpret mode);
    the halo path (``impl="pallas"``) agrees too."""
    ref = reference(("logits", "pallas-stack"))
    tparams = params_from_numpy(weights, "cpu")
    tsparse, _ = tg.sparsify(nets[1], tparams, DENSITY)
    x = torch.from_numpy(images)
    for impl in ("pallas-stack", "pallas"):
        _assert_close(tg.net_apply(nets[1], tparams, x, sparse=tsparse,
                                   impl=impl), ref)


def test_dense_logits_match_reference(nets, weights, images):
    """The dense path (grouped dense conv oracle, BN explicit) vs the
    reference's dense walker."""
    ref = np.asarray(jg.net_apply(nets[0], jax.tree.map(jnp.asarray, weights),
                                  jnp.asarray(images)))
    y = tg.net_apply(nets[1], params_from_numpy(weights, "cpu"),
                     torch.from_numpy(images))
    _assert_close(y, ref)


@pytest.mark.parametrize("impl", ["plain", "pallas-stack"])
def test_server_delivers_every_request(impl):
    """The reduced config (32 px, 200 classes) served at batch 4 on the
    CPU: five requests, all delivered, logits equal to net_apply."""
    cfg = get_config("vscnn-mobilenet-v1").reduce()
    srv = CNNServer(cfg, batch=4, impl=impl, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    imgs = [rng.standard_normal((32, 32, 3)).astype(np.float32)
            for _ in range(5)]
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    stats = srv.serve(reqs)
    assert sum(s["images"] for s in stats) == 5
    assert all(r.outcome.status == "delivered" for r in reqs)
    with torch.inference_mode():
        ref = torch.cat([
            tg.net_apply(srv.net, srv.params,
                         torch.from_numpy(np.stack(imgs[a:b])),
                         sparse=srv.sparse, impl="plain")
            for a, b in ((0, 4), (4, 5))]).numpy()
    for i, r in enumerate(reqs):
        assert r.logits.shape == (200,)
        _assert_close(r.logits, ref[i])
