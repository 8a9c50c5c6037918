"""The port's `models/cnn.py` shims against the reference's, on the CPU.

VGG-16 at 32 px with 16 classes (`vgg16_schema(16, image_size=32)`) and
the ResNet-style stem, batch 2, the weights made with numpy from a seed
for the reference's schema and handed to both sides.  The reference's
forwards are jitted ``impl="jnp"``; the port's run its plain path (CPU
tensors, ``impl="auto"``).  `conv_names`, `RESNET_STEM_LAYERS` and the
schemas equal; `sparsify_vgg16` / `sparsify_resnet_stem` at density 0.5
give the reference's encodings and pruned weights byte for byte;
`vgg16_apply` and `resnet_stem_apply`, dense and sparse, and
`collect_conv_traffic`'s recorded inputs within 1e-5 of the largest
value; every shim equal to the graph call it delegates to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as RC
from repro_torch.models import cnn as TC
from repro_torch.models import graph as tg
from repro_torch.params import params_from_numpy

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
DENSITY = 0.5


def _close(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() <= RTOL * max(np.abs(ref).max(), 1e-30)


def _weights(schema: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {name: {k: (rng.standard_normal(p.shape) * p.fan_in ** -0.5
                       if p.init == "normal" else
                       rng.normal(0, 0.1, p.shape)).astype(np.float32)
                   for k, p in leaves.items()}
            for name, leaves in schema.items()}


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def vgg():
    w = _weights(RC.vgg16_schema(16, image_size=32), 0)
    jp = jax.tree.map(jnp.asarray, w)
    jsparse, jpruned = RC.sparsify_vgg16(jp, DENSITY)
    return w, jp, jsparse, jpruned


@pytest.fixture(scope="module")
def stem():
    w = _weights(RC.resnet_stem_schema(), 2)
    jp = jax.tree.map(jnp.asarray, w)
    jsparse, jpruned = RC.sparsify_resnet_stem(jp, DENSITY)
    return w, jp, jsparse, jpruned


def test_names_and_layers_equal_the_reference():
    assert TC.conv_names() == RC.conv_names()
    assert len(TC.conv_names()) == 13
    assert TC.RESNET_STEM_LAYERS == RC.RESNET_STEM_LAYERS
    assert TC.VGG16_LAYERS == RC.VGG16_LAYERS


@pytest.mark.parametrize("which", ["vgg16", "stem"])
def test_schemas_equal_the_reference(which):
    t = TC.vgg16_schema(16, image_size=32) if which == "vgg16" else \
        TC.resnet_stem_schema()
    r = RC.vgg16_schema(16, image_size=32) if which == "vgg16" else \
        RC.resnet_stem_schema()
    assert t.keys() == r.keys()
    for name in r:
        assert {k: (tuple(p.shape), p.init) for k, p in t[name].items()} \
            == {k: (tuple(p.shape), p.init) for k, p in r[name].items()}


def _check_sparse(tsparse, tpruned, jsparse, jpruned):
    assert tsparse.keys() == jsparse.keys()
    for name, j in jsparse.items():
        t = tsparse[name]
        assert t.vs.vals.numpy().tobytes() == np.asarray(j.vs.vals).tobytes()
        assert t.vs.idx.numpy().tobytes() == np.asarray(j.vs.idx).tobytes()
    for name, leaves in jpruned.items():
        for k, v in leaves.items():
            assert tpruned[name][k].numpy().tobytes() == \
                np.asarray(v).tobytes(), (name, k)


def test_sparsify_vgg16_equals_the_reference(vgg):
    w, _, jsparse, jpruned = vgg
    tsparse, tpruned = TC.sparsify_vgg16(params_from_numpy(w, "cpu"),
                                         DENSITY)
    assert len(tsparse) == 16  # 13 convs, 3 FCs (fc3 a remainder strip)
    _check_sparse(tsparse, tpruned, jsparse, jpruned)


def test_sparsify_resnet_stem_equals_the_reference(stem):
    w, _, jsparse, jpruned = stem
    tsparse, tpruned = TC.sparsify_resnet_stem(params_from_numpy(w, "cpu"),
                                               DENSITY)
    _check_sparse(tsparse, tpruned, jsparse, jpruned)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_vgg16_apply_equals_the_reference(vgg, images, sparse):
    w, jp, jsparse, _ = vgg
    js = jsparse if sparse else None
    ref = jax.jit(lambda p, x: RC.vgg16_apply(p, x, sparse=js, impl="jnp"))(
        jp, jnp.asarray(images))
    tp = params_from_numpy(w, "cpu")
    ts = TC.sparsify_vgg16(tp, DENSITY)[0] if sparse else None
    y = TC.vgg16_apply(tp, torch.from_numpy(images), sparse=ts)
    assert y.shape == (2, 16)
    _close(y.numpy(), ref)
    direct = tg.net_apply(tg.build_vgg16(), tp, torch.from_numpy(images),
                          sparse=ts)
    assert torch.equal(y, direct)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_resnet_stem_apply_equals_the_reference(stem, images, sparse):
    w, jp, jsparse, _ = stem
    js = jsparse if sparse else None
    ref = jax.jit(lambda p, x: RC.resnet_stem_apply(p, x, sparse=js,
                                                    impl="jnp"))(
        jp, jnp.asarray(images))
    tp = params_from_numpy(w, "cpu")
    ts = TC.sparsify_resnet_stem(tp, DENSITY)[0] if sparse else None
    y = TC.resnet_stem_apply(tp, torch.from_numpy(images), sparse=ts)
    assert y.shape == (2, 8, 8, 128)
    _close(y.numpy(), ref)


def test_collect_conv_traffic_equals_the_reference(vgg, images):
    w, jp, _, _ = vgg
    ref = RC.collect_conv_traffic(jp, jnp.asarray(images))
    got = TC.collect_conv_traffic(params_from_numpy(w, "cpu"),
                                  torch.from_numpy(images))
    assert [n for n, *_ in got] == [n for n, *_ in ref] == \
        [n for n, _, _ in TC.conv_names()]
    for (n, x, wt), (_, rx, rw) in zip(got, ref):
        _close(x.numpy(), rx)
        assert wt.numpy().tobytes() == np.asarray(rw).tobytes(), n
