"""VGG-16 (the paper's evaluation network) through the port against the JAX
reference, on the CPU.

The reduced config (`vscnn-vgg16` ``reduce()``: 32 px, 16 classes, so
fc1's fan-in is 512), batch 2.  The weights are made with numpy from a
seed for the reference's schema and handed to both sides through the
weights bridge.  Each reference forward is one jitted ``impl="jnp"``
forward, computed once per module.

Tolerances: encodings exactly; f32 logits to a relative 1e-5 of max|y|
(the only difference is the order of the f32 sums); int8 logits bit for
bit (power-of-two scales and exact integer partials on both sides).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.models import graph as jg
from repro_torch.configs import get_config
from repro_torch.kernels.vsconv import use_stem_body
from repro_torch.launch.serve import CNNServer, ImageRequest
from repro_torch.models import graph as tg
from repro_torch.params import params_from_numpy, sparse_from_numpy

jcfg = importlib.import_module("repro.configs.vscnn_vgg16").CONFIG

RTOL = 1e-5
CFG = get_config("vscnn-vgg16")
SMALL = CFG.reduce()


def _assert_close(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    assert y.shape == ref.shape
    err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= RTOL, err


@pytest.fixture(scope="module")
def nets():
    return (jg.build_vgg16(SMALL.num_classes, image_size=SMALL.image_size),
            SMALL.build())


@pytest.fixture(scope="module")
def weights(nets):
    """A numpy tree for the reference's schema: normal weights at
    fan_in^-1/2 and small random biases."""
    rng = np.random.default_rng(0)
    tree = {}
    for name, leaves in nets[0].schema().items():
        tree[name] = {}
        for leaf, p in leaves.items():
            v = (rng.standard_normal(p.shape) * p.fan_in ** -0.5
                 if p.init == "normal" else rng.normal(0, 0.1, p.shape))
            tree[name][leaf] = v.astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def reference(nets, weights, images):
    """(density, dtype) -> (the reference's sparse tree, its jitted
    ``impl="jnp"`` logits), each computed once."""
    jparams = jax.tree.map(jnp.asarray, weights)
    cache = {}

    def get(density, dtype=None):
        key = (density, dtype)
        if key not in cache:
            jsparse, _ = jg.sparsify(nets[0], jparams, density, dtype=dtype)
            logits = jax.jit(lambda w, x: jg.net_apply(
                nets[0], w, x, sparse=jsparse, impl="jnp"))(
                    jparams, jnp.asarray(images))
            cache[key] = jsparse, np.asarray(logits)
        return cache[key]

    return get


def test_config_matches_reference():
    for f in ("name", "modality", "image_size", "num_classes",
              "weight_density", "vk", "vn", "fixed_image_size"):
        assert getattr(CFG, f) == getattr(jcfg, f), f
        assert getattr(SMALL, f) == getattr(jcfg.reduce(), f), f
    assert (SMALL.image_size, SMALL.num_classes) == (32, 16)
    assert CFG.fixed_image_size


def test_builder_matches_reference(nets):
    jnet, tnet = nets
    assert tnet.name == jnet.name == "vgg16"
    assert len(tnet.layers) == len(jnet.layers)
    for t, j in zip(tnet.layers, jnet.layers):
        assert type(t).__name__ == type(j).__name__
        assert dataclasses.asdict(t) == {
            k: v for k, v in dataclasses.asdict(j).items()
            if k in dataclasses.asdict(t)}
    assert tg.VGG16_LAYERS == jg.VGG16_LAYERS
    js, ts = jnet.schema(), tnet.schema()
    assert ts.keys() == js.keys()
    for name in js:
        assert {k: tuple(p.shape) for k, p in ts[name].items()} == \
            {k: tuple(p.shape) for k, p in js[name].items()}
    # fc1's fan-in follows the image size: 512 * (224 // 32)^2 at full size
    full = {l.name: l for l in CFG.build().layers if isinstance(l, tg.FC)}
    assert (full["fc1"].din, full["fc1"].dout) == (25088, 4096)
    assert (full["fc3"].din, full["fc3"].dout, full["fc3"].relu) == (
        4096, 1000, False)


@pytest.mark.parametrize("density,dtype", [(CFG.weight_density, None),
                                           (1.0, None),
                                           (CFG.weight_density, "int8")])
def test_sparsify_reproduces_reference_encoding(nets, weights, reference,
                                                density, dtype):
    jsparse, _ = reference(density, dtype)
    tsparse, _ = tg.sparsify(nets[1], params_from_numpy(weights, "cpu"),
                             density, vk=CFG.vk, vn=CFG.vn, dtype=dtype)
    assert tsparse.keys() == jsparse.keys()
    assert len(tsparse) == 16  # 13 convs and 3 FCs
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
    conv1 = tsparse["conv1"]
    assert (conv1.cin_pad, conv1.vs.vk, conv1.vs.vn) == (5, 8, 64)
    # conv1 at 224 px runs the conv kernels' stem body in f32
    assert use_stem_body(8, 8, 1, 3, 3, 64, stride=1)


@pytest.mark.parametrize("density", [CFG.weight_density, 1.0])
def test_f32_logits_match_reference_jnp(nets, weights, images, reference,
                                        density):
    """Port ``impl="plain"``, ``"pallas"`` and ``"pallas-stack"`` (the
    kernels' plain versions over both layouts on the CPU) with its own
    sparse tree, and the bridged reference tree, vs the reference's
    ``impl="jnp"``."""
    jsparse, ref = reference(density)
    tparams = params_from_numpy(weights, "cpu")
    tsparse, _ = tg.sparsify(nets[1], tparams, density)
    x = torch.from_numpy(images)
    for impl in ("plain", "pallas", "pallas-stack"):
        y = tg.net_apply(nets[1], tparams, x, sparse=tsparse, impl=impl)
        assert y.shape == (2, 16)
        _assert_close(y, ref)
    _assert_close(tg.net_apply(nets[1], tparams, x, impl="plain",
                               sparse=sparse_from_numpy(jsparse, "cpu")),
                  ref)


def test_int8_logits_bit_equal_to_reference(nets, weights, images,
                                            reference):
    _, ref = reference(CFG.weight_density, "int8")
    tparams = params_from_numpy(weights, "cpu")
    tsparse, _ = tg.sparsify(nets[1], tparams, CFG.weight_density,
                             dtype="int8")
    x = torch.from_numpy(images)
    for impl in ("plain", "pallas", "pallas-stack"):
        y = tg.net_apply(nets[1], tparams, x, sparse=tsparse, impl=impl)
        assert y.dtype == torch.float32
        assert_array_equal(y.numpy(), ref)


def test_dense_logits_match_reference(nets, weights, images):
    ref = np.asarray(jax.jit(lambda w, x: jg.net_apply(nets[0], w, x))(
        jax.tree.map(jnp.asarray, weights), jnp.asarray(images)))
    y = tg.net_apply(nets[1], params_from_numpy(weights, "cpu"),
                     torch.from_numpy(images))
    _assert_close(y, ref)


@pytest.mark.parametrize("dtype,impl", [(None, "auto"),
                                        ("int8", "pallas-stack")])
def test_server_pads_to_the_fixed_size_and_refuses_larger(dtype, impl):
    """The Flatten head fixes the input at 32 px: a 24 px image is padded
    (zeros at the bottom and right) into the 32 px bucket, a 40 px image
    is refused at admission with the reference's reason, and the rest
    are delivered, equal to `net_apply` on the padded wave."""
    srv = CNNServer(SMALL, batch=4, seed=0, dtype=dtype, impl=impl,
                    device="cpu")
    rng = np.random.default_rng(2)
    imgs = [rng.standard_normal((s, s, 3)).astype(np.float32)
            for s in (32, 24, 40, 32)]
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    srv.serve(reqs)
    big = reqs[2].outcome
    assert big.status == "refused"
    assert big.reason == "invalid:" + jg.input_refusal(
        imgs[2], max_size=32, channels=3)
    served = [0, 1, 3]
    x = np.zeros((4, 32, 32, 3), np.float32)  # the wave, padded to pow2
    for i, j in enumerate(served):
        h = imgs[j].shape[0]
        x[i, :h, :h] = imgs[j]
    with torch.inference_mode():
        ref = tg.net_apply(srv.net, srv.params, torch.from_numpy(x),
                           sparse=srv.sparse, impl="plain").numpy()
    for i, j in enumerate(served):
        r = reqs[j]
        assert r.outcome.status == "delivered"
        assert r.logits.shape == (16,)
        if dtype == "int8":
            assert_array_equal(r.logits, ref[i])
        else:
            _assert_close(r.logits, ref[i])
