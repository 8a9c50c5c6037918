"""The port's int8 networks and int8 serving against the reference.

ResNet-18 and MobileNetV1 at 32 px with 10-class heads and randomised BN
statistics.  The weights are drawn once by the reference's `init_params`,
randomised with numpy and handed to both sides through the weights
bridge.  Both sides then quantize, encode and run int8 in the same
arithmetic, so everything is compared bit for bit: the encodings
(``idx``, int8 ``vals``, ``scale``, ``bias``, the dequantized pruned
tree) and the logits against the reference's int8 ``impl="jnp"``, with
the port's own `sparsify` result and with the reference's carried over by
`sparse_from_numpy`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.models import graph as jg
from repro.models.layers import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.launch.serve import CNNServer, ImageRequest
from repro_torch.models import graph as tg
from repro_torch.params import params_from_numpy, sparse_from_numpy

NETS = {"resnet18": (jg.build_resnet18, tg.build_resnet18),
        "mobilenet_v1": (jg.build_mobilenet_v1, tg.build_mobilenet_v1)}


@pytest.fixture(scope="module")
def models():
    """name -> (reference net, port net, numpy weights, BN randomised)."""
    out = {}
    for i, (name, (jb, tb)) in enumerate(NETS.items()):
        jnet, tnet = jb(10), tb(10)
        tree = jax.tree.map(np.asarray, jinit(
            jnet.schema(), jax.random.PRNGKey(i), jnp.float32))
        rng = np.random.default_rng(i)
        for entry in tree.values():
            if "scale" in entry:
                c = entry["scale"].shape[0]
                entry["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                entry["offset"] = rng.normal(0, 0.1, c).astype(np.float32)
                entry["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                entry["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        out[name] = (jnet, tnet, tree)
    return out


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(7).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


def _assert_entries_equal(jsparse, tsparse):
    assert sorted(jsparse) == sorted(tsparse)
    for name, je in jsparse.items():
        te = tsparse[name]
        assert te.vs.vals.dtype == torch.int8, name
        assert_array_equal(te.vs.vals.numpy(), np.asarray(je.vs.vals))
        assert_array_equal(te.vs.idx.numpy(), np.asarray(je.vs.idx))
        assert te.vs.shape == tuple(je.vs.shape)
        assert_array_equal(te.scale.numpy(), np.asarray(je.scale))
        assert_array_equal(te.bias.numpy(), np.asarray(je.bias))


@pytest.mark.parametrize("density", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("name", sorted(NETS))
def test_int8_net_bit_equal_to_reference(models, images, name, density):
    jnet, tnet, tree = models[name]
    jw = jax.tree.map(jnp.asarray, tree)
    jsparse, jpruned = jg.sparsify(jnet, jw, density, dtype="int8")
    ref = np.asarray(jg.net_apply(jnet, jw, jnp.asarray(images),
                                  sparse=jsparse, impl="jnp"))
    tparams = params_from_numpy(tree, "cpu")
    tsparse, tpruned = tg.sparsify(tnet, tparams, density, dtype="int8")
    _assert_entries_equal(jsparse, tsparse)
    for lname, p in jpruned.items():  # the dequantized pruned tree
        for key, v in p.items():
            assert_array_equal(tpruned[lname][key].numpy(), np.asarray(v))
    x = torch.from_numpy(images)
    y = tg.net_apply(tnet, tparams, x, sparse=tsparse, impl="plain")
    assert y.dtype == torch.float32
    assert_array_equal(y.numpy(), ref)
    bridged = sparse_from_numpy(jsparse, "cpu")
    assert_array_equal(
        tg.net_apply(tnet, tparams, x, sparse=bridged, impl="auto").numpy(),
        ref)


def test_int8_tree_crosses_the_bridge_unchanged(models):
    jnet, _, tree = models["resnet18"]
    jsparse, _ = jg.sparsify(jnet, jax.tree.map(jnp.asarray, tree), 0.5,
                             dtype="int8")
    _assert_entries_equal(jsparse, sparse_from_numpy(jsparse, "cpu"))


def test_int8_fc_remainder_strip_matches_reference():
    """A 1000-class head pads to 1024 columns: the pad columns are all
    zero, take scale 1.0 and are sliced off."""
    jnet = jg.SparseNet("fc", (jg.Classifier("fc", 64, 1000),))
    tnet = tg.SparseNet("fc", (tg.Classifier("fc", 64, 1000),))
    rng = np.random.default_rng(5)
    w = {"fc": {"w": rng.standard_normal((64, 1000)).astype(np.float32),
                "b": rng.standard_normal(1000).astype(np.float32)}}
    x = rng.standard_normal((3, 64)).astype(np.float32)
    jw = jax.tree.map(jnp.asarray, w)
    jsparse, _ = jg.sparsify(jnet, jw, 0.5, dtype="int8")
    tparams = params_from_numpy(w, "cpu")
    tsparse, _ = tg.sparsify(tnet, tparams, 0.5, dtype="int8")
    assert tsparse["fc"].vs.shape == (64, 1024)
    assert_array_equal(tsparse["fc"].scale[1000:].numpy(), np.ones(24))
    assert_array_equal(tsparse["fc"].scale.numpy(),
                       np.asarray(jsparse["fc"].scale))
    y = tg.net_apply(tnet, tparams, torch.from_numpy(x), sparse=tsparse)
    assert y.shape == (3, 1000)
    assert_array_equal(y.numpy(), np.asarray(jg.net_apply(
        jnet, jw, jnp.asarray(x), sparse=jsparse, impl="jnp")))


@pytest.mark.parametrize("arch", ["vscnn-resnet18", "vscnn-mobilenet-v1"])
def test_int8_server_equals_direct_apply(arch):
    """Eight requests at batch 4 (two full waves): every request delivered
    and bit-equal to `net_apply(impl="plain")` on the same waves (the
    activation scale is per tensor, so a wave's images share it)."""
    cfg = get_config(arch).reduce()
    srv = CNNServer(cfg, batch=4, density=0.5, seed=0, dtype="int8",
                    device="cpu")
    assert all(e.vs.vals.dtype == torch.int8 and e.scale is not None
               for e in srv.sparse.values())
    rng = np.random.default_rng(3)
    imgs = [rng.standard_normal((32, 32, 3)).astype(np.float32)
            for _ in range(8)]
    reqs = [ImageRequest(rid=i, image=im) for i, im in enumerate(imgs)]
    stats = srv.serve(reqs)
    assert sum(s["steps"] for s in stats) == 2
    with torch.inference_mode():
        ref = torch.cat([
            tg.net_apply(srv.net, srv.params,
                         torch.from_numpy(np.stack(imgs[a:a + 4])),
                         sparse=srv.sparse, impl="plain")
            for a in (0, 4)]).numpy()
    for i, r in enumerate(reqs):
        assert r.outcome.status == "delivered"
        assert np.isfinite(r.logits).all()
        assert_array_equal(r.logits, ref[i])
