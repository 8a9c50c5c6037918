"""The port's logical-axis sharding (`repro_torch.parallel.sharding`) and
mesh builders (`repro_torch.launch.mesh`) against the reference's.

`spec_for` is held case for case against `repro.parallel.sharding.
spec_for` on shape-only meshes (the port's `AbstractMesh`, the
reference's ``jax.sharding.AbstractMesh``): the reference's own
`TestMeshRules` cases, the 16x16 KV-head demotion, the ``("pod",
"data")`` filter on one pod and on two, repeated and missing axes, and
every parameter leaf of the full-size LM schemas on the production
meshes.  The DTensor placements of each spec, `logical` as the identity
outside a mesh, `sharding_tree`'s nesting, and one rank's round trip
through `distribute` / `local` / `from_local` in a one-rank gloo world.
"""
import dataclasses

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro.models.layers import axes_tree as ref_axes_tree
from repro.parallel import sharding as RS
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import axes_tree
from repro_torch.parallel import sharding as shd


def _ref_mesh(sizes, names):
    try:
        return jax.sharding.AbstractMesh(tuple(sizes), tuple(names))
    except TypeError:  # jax 0.4.37 takes (name, size) pairs
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


def _both(sizes, names, axes, shape, rules="train"):
    ref_rules = RS.TRAIN_RULES if rules == "train" else rules[0]
    port_rules = shd.TRAIN_RULES if rules == "train" else rules[1]
    want = RS.spec_for(axes, mesh=_ref_mesh(sizes, names), rules=ref_rules,
                       shape=shape)
    got = shd.spec_for(axes, mesh=shd.AbstractMesh(tuple(sizes),
                                                   tuple(names)),
                       rules=port_rules, shape=shape)
    return tuple(got), tuple(want)


CASES = [
    # the reference's TestMeshRules, on shape-only meshes
    ((1, 1), ("data", "model"), ("batch", "kv_heads"), (4, 8)),
    ((1, 1), ("data", "model"), ("batch",), (8,)),
    ((1, 1), ("data", "model"), ("heads", "ff"), (4, 4)),
    ((1, 2), ("data", "model"), ("ff",), (7,)),
    ((1, 2), ("data", "model"), ("ff",), (8,)),
    ((16, 16), ("data", "model"), ("batch", None, "kv_heads", "head_dim"),
     (256, 4096, 8, 128)),
    # the serving layouts of this slice
    ((2, 2), ("data", "model"), ("batch", "seq_sp", "heads", "head_dim"),
     (4, 32, 4, 32)),
    ((2, 2), ("data", "model"), ("batch", "seq_sp", "heads", "head_dim"),
     (4, 31, 4, 32)),
    ((2, 2), ("data", "model"), ("batch", "seq", "heads", "head_dim"),
     (4, 32, 4, 32)),
    ((2, 2), ("data", "model"), ("batch", "kv_seq", "kv_heads", "head_dim"),
     (4, 64, 4, 32)),
    ((2, 2), ("data", "model"), ("batch", "kv_seq", "kv_heads", "head_dim"),
     (3, 63, 4, 32)),
    ((2, 2), ("data", "model"), (None, "expert", None, "fsdp"),
     (2, 8, 128, 64)),
    ((1, 4), ("data", "model"), ("expert", "fsdp", None), (8, 64, 128)),
    ((4, 1), ("data", "model"), ("fsdp", None), (128, 8)),
    ((2, 2), ("data", "model"), ("stack", "ff", None, None, None, None),
     (2, 2, 1, 1, 32, 128)),
    ((2, 2), ("data", "model"), ("vocab", "fsdp"), (512, 128)),
    ((4,), ("model",), ("ff", None, None, None), (8, 16, 32, 128)),
    ((4,), ("model",), ("ff", None, None, None), (1, 16, 32, 128)),
    ((4,), ("model",), ("conv", None, None, None), (8, 16, 32, 128)),
    # the pod axis: filtered on one pod, kept (major) on two
    ((16, 16), ("data", "model"), ("batch", "seq", "embed"),
     (256, 4096, 2560)),
    ((2, 16, 16), ("pod", "data", "model"), ("batch", "seq", "embed"),
     (256, 4096, 2560)),
    ((2, 16, 16), ("pod", "data", "model"), ("batch", "seq", "embed"),
     (16, 4096, 2560)),
    ((2, 16, 16), ("pod", "data", "model"), ("fsdp", "heads", "head_dim"),
     (2560, 20, 128)),
    # no shape: no divisibility demotion
    ((16, 16), ("data", "model"), ("batch", "kv_heads", None), None),
    ((2, 2), ("data", "model"), ("ff", "vocab", "heads"), None),
]


@pytest.mark.parametrize("sizes,names,axes,shape", CASES)
def test_spec_for_equals_the_reference(sizes, names, axes, shape):
    got, want = _both(sizes, names, axes, shape)
    assert got == want


def test_replaced_rules_equal_the_reference():
    ref = RS.TRAIN_RULES.replace(conv="model", batch="data")
    port = shd.TRAIN_RULES.replace(conv="model", batch="data")
    assert tuple(port.rules) == tuple(ref.rules)
    got, want = _both((2, 4), ("data", "model"), ("conv", "batch", "ff"),
                      (8, 4, 8), rules=(ref, port))
    assert got == want == ("model", "data", None)


def test_rule_tables_copied():
    assert tuple(shd.TRAIN_RULES.rules) == tuple(RS.TRAIN_RULES.rules)
    assert tuple(shd.SERVE_RULES.rules) == tuple(RS.SERVE_RULES.rules)


FULL_ARCHS = ["qwen1.5-4b", "granite-moe-3b-a800m", "gemma3-12b",
              "jamba-v0.1-52b", "kimi-k2-1t-a32b", "rwkv6-3b"]


def _leaves(axes, shapes, path=""):
    if isinstance(axes, tuple):
        yield path, axes, shapes
    elif isinstance(axes, list):
        for i, (a, s) in enumerate(zip(axes, shapes)):
            yield from _leaves(a, s, f"{path}[{i}]")
    else:
        for k in axes:
            yield from _leaves(axes[k], shapes[k], f"{path}/{k}")


def _shapes(schema):
    if hasattr(schema, "shape") and hasattr(schema, "axes"):
        return tuple(schema.shape)
    if isinstance(schema, list):
        return [_shapes(v) for v in schema]
    return {k: _shapes(v) for k, v in schema.items()}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("name", FULL_ARCHS)
def test_every_param_leaf_on_the_production_mesh(name, multi_pod):
    """Each leaf of the full-size schema, on 16x16 (and 2x16x16): the
    port's spec is the reference's."""
    ref_schema = RT.lm_schema(ref_get_config(name))
    schema = tfm.lm_schema(get_config(name))
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    ref_mesh = _ref_mesh(mesh.axis_sizes, mesh.axis_names)
    want = {p: tuple(RS.spec_for(a, mesh=ref_mesh, rules=RS.SERVE_RULES,
                                 shape=s))
            for p, a, s in _leaves(ref_axes_tree(ref_schema),
                                   _shapes(ref_schema))}
    got = {p: tuple(shd.spec_for(a, mesh=mesh, rules=shd.SERVE_RULES,
                                 shape=s))
           for p, a, s in _leaves(axes_tree(schema), _shapes(schema))}
    assert got == want


def test_production_mesh_and_name():
    m = tmesh.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    assert tmesh.mesh_name(m) == "data16xmodel16"
    m2 = tmesh.make_production_mesh(multi_pod=True)
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.mesh_name(m2) == "pod2xdata16xmodel16"


@pytest.mark.parametrize("spec,want", [
    (("data", None, "model"), (Shard(0), Shard(2))),
    ((None, "model"), (Replicate(), Shard(1))),
    ((None, None), (Replicate(), Replicate())),
    (("model", "data"), (Shard(1), Shard(0))),
])
def test_placements_of_a_spec(spec, want):
    mesh = shd.AbstractMesh((2, 2), ("data", "model"))
    assert shd.placements(shd.PartitionSpec(*spec), mesh) == want


def test_placements_of_a_pod_data_dim():
    """A dim on ("pod", "data") shards on both mesh dims (pod the major
    one), and the model dim stays replicated."""
    mesh = tmesh.make_production_mesh(multi_pod=True)
    spec = shd.spec_for(("batch", "seq", "embed"), mesh=mesh,
                        rules=shd.SERVE_RULES, shape=(256, 8, 8))
    assert tuple(spec) == (("pod", "data"), None, None)
    assert shd.placements(spec, mesh) == (Shard(0), Shard(0), Replicate())


def test_logical_is_the_identity_outside_a_mesh():
    x = torch.ones(4, 4)
    assert shd.current() is None
    assert shd.logical(x, ("batch", None)) is x


def test_logical_needs_a_dtensor_under_a_mesh():
    with shd.use_mesh(shd.AbstractMesh((1, 1), ("data", "model"))):
        with pytest.raises(TypeError):
            shd.logical(torch.ones(2, 2), ("batch", None))
    assert shd.current() is None


def test_use_mesh_nests_and_restores():
    a = shd.AbstractMesh((1, 2), ("data", "model"))
    b = shd.AbstractMesh((2, 1), ("data", "model"))
    with shd.use_mesh(a) as ca:
        assert shd.current() is ca and ca.rules is shd.TRAIN_RULES
        with shd.use_mesh(b, shd.SERVE_RULES) as cb:
            assert shd.current() is cb and cb.shape == {"data": 2,
                                                        "model": 1}
        assert shd.current() is ca
    assert shd.current() is None


def test_sharding_tree_keeps_the_nesting():
    mesh = shd.AbstractMesh((2, 2), ("data", "model"))
    cfg = dataclasses.replace(get_config("qwen1.5-4b").reduce(), tp_hint=2)
    schema = tfm.lm_schema(cfg)
    with shd.use_mesh(mesh, shd.SERVE_RULES):
        tree = shd.sharding_tree(axes_tree(schema), _shapes(schema))
    assert isinstance(tree["segments"], list)
    wq = tree["segments"][0]["l0"]["mix"]["wq"]
    assert tuple(wq.spec) == (None, "data", "model", None)
    assert wq.placements == (Shard(1), Shard(2))
    assert tuple(tree["embed"].spec) == ("model", "data")


def test_named_sharding_needs_a_mesh():
    with pytest.raises(RuntimeError):
        shd.named_sharding(("batch",))


def _round_trip(tmp_path):
    import torch.distributed as dist
    tmesh.init_process_group(str(tmp_path / "store"), rank=0, world_size=1,
                             device="cpu")
    try:
        mesh = tmesh.make_local_mesh()
        assert tmesh.mesh_name(mesh) == "data1xmodel1"
        x = torch.arange(24.0).reshape(2, 3, 4)
        with shd.use_mesh(mesh, shd.SERVE_RULES):
            d = shd.distribute(x, ("batch", None, "ff"))
            assert d.placements == (Shard(0), Shard(2))
            assert torch.equal(d.full_tensor(), x)
            assert torch.equal(shd.local(d, (None, None, None)), x)
            back = shd.from_local(x, ("batch", None, "ff"), (2, 3, 4))
            assert torch.equal(back.full_tensor(), x)
            z = shd.zeros((2, 6), ("batch", "ff"), dtype=torch.float32,
                          device=torch.device("cpu"))
            assert z.to_local().shape == (2, 6)
            assert shd.axis_index("model") == 0
            assert shd.axis_size(("data", "model")) == 1
            t = torch.ones(3)
            assert torch.equal(shd.all_reduce(t, "model"), torch.ones(3))
        model = tmesh.make_model_mesh()
        assert tmesh.mesh_name(model) == "model1"
        with pytest.raises(ValueError):
            tmesh.make_local_mesh(data=2, model=1)
    finally:
        dist.destroy_process_group()


def test_one_rank_world_round_trip(tmp_path):
    _round_trip(tmp_path)
