"""The port's network IR, sparsify and executor against the JAX reference.

ResNet-18 at 32 px with a 10-class head and randomised BN statistics (so
BN folding is exercised).  The weights are drawn once by the reference's
`init_params`, randomised with numpy and handed to both sides through the
weights bridge, so both compute with the same numbers.

Tolerances: encodings are compared exactly (both sides fold BN and prune
in the same numpy arithmetic); logits to a relative 1e-5 of max|y| (the
only difference is the order of the f32 sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import graph as jg
from repro.models.layers import init_params as jinit
from repro_torch.models import graph as tg
from repro_torch.models import layers as tl
from repro_torch.params import params_from_numpy, sparse_from_numpy

RTOL = 1e-5
DENSITIES = (1.0, 0.5, 0.25)


def _assert_close(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    assert y.shape == ref.shape
    err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= RTOL, err


@pytest.fixture(scope="module")
def nets():
    return jg.build_resnet18(10), tg.build_resnet18(10)


@pytest.fixture(scope="module")
def weights(nets):
    """Reference-initialised ResNet-18 params as numpy, BN randomised."""
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
def reference(nets, weights):
    """The reference's sparsify result per density (built lazily)."""
    jparams = jax.tree.map(jnp.asarray, weights)
    cache = {}

    def get(d):
        if d not in cache:
            cache[d] = jg.sparsify(nets[0], jparams, d)
        return jparams, cache[d]

    return get


@pytest.mark.parametrize("density", DENSITIES)
def test_sparsify_reproduces_reference_encoding(nets, weights, reference,
                                                density):
    _, (jsparse, jpruned) = reference(density)
    tsparse, tpruned = tg.sparsify(nets[1], params_from_numpy(weights, "cpu"),
                                   density)
    assert tsparse.keys() == jsparse.keys()
    for name, j in jsparse.items():
        t = tsparse[name]
        np.testing.assert_array_equal(t.vs.idx.numpy(), np.asarray(j.vs.idx))
        np.testing.assert_array_equal(t.vs.vals.numpy(),
                                      np.asarray(j.vs.vals))
        np.testing.assert_array_equal(t.bias.numpy(), np.asarray(j.bias))
        assert t.vs.shape == j.vs.shape
        if isinstance(t, tg.SparseConv):
            assert (t.kh, t.kw, t.stride, t.groups, t.dilation, t.cin_pad) \
                == (j.kh, j.kw, j.stride, j.groups, j.dilation, j.cin_pad)
        else:
            assert t.dout == j.dout
    for name, entry in jpruned.items():
        for leaf, value in entry.items():
            np.testing.assert_array_equal(tpruned[name][leaf].numpy(),
                                          np.asarray(value))


@pytest.mark.parametrize("density", DENSITIES)
def test_logits_match_reference(nets, weights, images, reference, density):
    """Port logits (CPU plain path) vs the reference's ``impl="jnp"``, with
    the port's own sparse tree and with the bridged reference tree."""
    jparams, (jsparse, _) = reference(density)
    ref = np.asarray(jg.net_apply(nets[0], jparams, jnp.asarray(images),
                                  sparse=jsparse, impl="jnp"))
    tparams = params_from_numpy(weights, "cpu")
    tsparse, _ = tg.sparsify(nets[1], tparams, density)
    x = torch.from_numpy(images)
    y_own = tg.net_apply(nets[1], tparams, x, sparse=tsparse, impl="plain")
    y_bridged = tg.net_apply(nets[1], tparams, x, impl="auto",
                             sparse=sparse_from_numpy(jsparse, "cpu"))
    assert y_own.shape == (2, 10)
    _assert_close(y_own, ref)
    _assert_close(y_bridged, ref)


def test_dense_logits_match_reference(nets, weights, images):
    """The dense path (BN applied explicitly, cuDNN-style conv oracle) vs
    the reference's dense walker."""
    ref = np.asarray(jg.net_apply(nets[0], jax.tree.map(jnp.asarray, weights),
                                  jnp.asarray(images)))
    y = tg.net_apply(nets[1], params_from_numpy(weights, "cpu"),
                     torch.from_numpy(images))
    _assert_close(y, ref)


@pytest.mark.parametrize("pool,size", [
    (tg.Pool("max", 3, stride=2, padding="SAME"), 112),  # pads (0, 1)
    (tg.Pool("max", 3, stride=2, padding="SAME"), 7),
    (tg.Pool("avg", 2), 8),
    (tg.Pool("gap"), 7),
])
def test_pool_matches_reference(pool, size):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 4)).astype(np.float32)
    jpool = jg.Pool(pool.kind, pool.size, pool.stride, pool.padding)
    y = tg._pool(pool, torch.from_numpy(x))
    _assert_close(y, jg._pool(jpool, jnp.asarray(x)))
    assert y.is_contiguous()


def test_tile_geometry_matches_reference():
    for kh, cin_g, cout, groups in [(7, 3, 64, 1), (3, 64, 64, 1),
                                    (1, 256, 512, 1), (3, 48, 96, 1),
                                    (3, 16, 64, 4), (3, 1, 32, 32)]:
        for vk, vn in [(32, 128), (8, 64)]:
            t = tg.conv_tile_geometry(kh, kh, cin_g, cout, vk=vk, vn=vn,
                                      groups=groups)
            j = jg.conv_tile_geometry(kh, kh, cin_g, cout, vk=vk, vn=vn,
                                      groups=groups)
            assert vars(t) == vars(j)
    for din, dout in [(512, 1000), (512, 10), (4096, 4096), (100, 10)]:
        t, j = tg.fc_tile_geometry(din, dout), jg.fc_tile_geometry(din, dout)
        assert (t is None and j is None) or vars(t) == vars(j)
    for kb in (1, 9, 144):
        for d in (0.01, 0.235, 1.0):
            assert tg.strip_steps(kb, d) == jg.strip_steps(kb, d)
    with pytest.raises(tg.TileGeometryError, match="VSC109") as err:
        tg.conv_tile_geometry(3, 3, 1, 64, groups=32)
    assert err.value.rule == "VSC109"


def test_fc_remainder_strip_matches_reference():
    """A 1000-class head pads to 1024 (NB 8) and slices back."""
    jnet = jg.SparseNet("head", (jg.Flatten(), jg.Classifier("fc", 64, 1000)))
    tnet = tg.SparseNet("head", (tg.Flatten(), tg.Classifier("fc", 64, 1000)))
    rng = np.random.default_rng(3)
    w = {"fc": {"w": rng.standard_normal((64, 1000)).astype(np.float32),
                "b": rng.standard_normal(1000).astype(np.float32)}}
    x = rng.standard_normal((3, 1, 1, 64)).astype(np.float32)
    jw = jax.tree.map(jnp.asarray, w)
    jsparse, _ = jg.sparsify(jnet, jw, 0.5)
    tparams = params_from_numpy(w, "cpu")
    tsparse, _ = tg.sparsify(tnet, tparams, 0.5)
    assert tsparse["fc"].vs.shape == (64, 1024)
    assert tsparse["fc"].vs.n_strips == 8
    y = tg.net_apply(tnet, tparams, torch.from_numpy(x), sparse=tsparse)
    assert y.shape == (3, 1000)
    _assert_close(y, jg.net_apply(jnet, jw, jnp.asarray(x), sparse=jsparse,
                                  impl="jnp"))


def test_init_params_laws_and_determinism(nets):
    schema = nets[1].schema()
    a = tl.init_params(schema, 0, device="cpu")
    b = tl.init_params(schema, 0, device="cpu")
    c = tl.init_params(schema, 1, device="cpu")
    assert torch.equal(a["layer4_1_conv2"]["w"], b["layer4_1_conv2"]["w"])
    assert not torch.equal(a["layer4_1_conv2"]["w"], c["layer4_1_conv2"]["w"])
    w = a["layer4_1_conv2"]["w"]
    assert w.shape == (3, 3, 512, 512) and w.dtype == torch.float32
    assert float(w.std()) == pytest.approx((9 * 512) ** -0.5, rel=0.02)
    assert torch.equal(a["conv1"]["scale"], torch.ones(64))
    assert torch.equal(a["conv1"]["mean"], torch.zeros(64))
    assert torch.equal(a["fc"]["b"], torch.zeros(10))
    # two leaves of one shape draw independently
    assert not torch.equal(a["layer1_0_conv1"]["w"], a["layer1_0_conv2"]["w"])


def test_unported_and_malformed_entries_raise(nets, weights):
    tparams = params_from_numpy(weights, "cpu")
    # int8, once unported, now encodes: int8 tiles and a scale per entry
    # (tests/test_torch_int8_net.py holds them against the reference)
    q, _ = tg.sparsify(nets[1], tparams, 0.5, dtype="int8")
    assert q["conv1"].vs.vals.dtype == torch.int8
    assert q["fc"].scale.shape == (10,)
    # a dtype the port does not encode still raises
    with pytest.raises(NotImplementedError, match="float32 or int8"):
        tg.sparsify(nets[1], tparams, 0.5, dtype=torch.bfloat16)
    # depthwise encoding, once unported, now encodes: the
    # (9, 32) tap matrix with vk 1, one 32-channel strip of 4 stored taps
    dw, wp = tg.sparse_conv_from_dense(
        np.arange(9 * 32, dtype=np.float32).reshape(3, 3, 1, 32), 0.5,
        groups=32)
    assert dw.vs.shape == (9, 32) and tuple(dw.vs.vals.shape) == (1, 4, 1, 32)
    assert dw.groups == 32 and wp.shape == (3, 3, 1, 32)
    tsparse, _ = tg.sparsify(nets[1], tparams, 0.5)
    bare = dict(tsparse, conv1=tsparse["conv1"].vs)  # BN conv, no folded bias
    with pytest.raises(ValueError, match="no folded bias"):
        tg.net_apply(nets[1], tparams, torch.zeros(1, 32, 32, 3), sparse=bare)
