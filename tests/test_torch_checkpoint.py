"""The port's checkpoint manager: the reference's integrity cases
(`tests/test_checkpoint.py`) against the port, and the on-disk format
shared with the reference in both directions.

A corrupted, truncated or missing leaf, or a torn manifest, raises
`CheckpointError` naming the array; a manifest without checksums
restores.  A checkpoint the reference writes (a reduced model's f32
params and AdamW state, its int32 step count) restores into the port
bit for bit, and the reverse; leaf paths are the reference's ``keystr``.
bf16 leaves round-trip through their uint16 bits.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager
from repro_torch.optim.optimizers import adamw
from repro_torch.params import params_from_numpy
from repro_torch.utils.tree import leaves, leaves_with_path

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_ref import configs, np_params


def _tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.ones((4,), dtype=torch.float32),
    }


def _save(d, step=0):
    cm = CheckpointManager(str(d), async_save=False)
    cm.save(step, _tree(), metadata={"k": "v"})
    return cm


def _manifest(d, step=0):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def _leaf_file(d, path, step=0):
    entry = next(leaf for leaf in _manifest(d, step)["leaves"]
                 if leaf["path"] == path)
    return os.path.join(d, f"step_{step}", entry["file"])


class TestIntegrity:
    def test_roundtrip_with_checksums(self, tmp_path):
        cm = _save(tmp_path)
        assert all(len(leaf["sha256"]) == 64
                   for leaf in _manifest(tmp_path)["leaves"])
        tree, step, meta = cm.restore(_tree())
        assert step == 0 and meta == {"k": "v"}
        assert torch.equal(tree["w"], _tree()["w"])

    def test_corrupted_leaf_named(self, tmp_path):
        cm = _save(tmp_path)
        fpath = _leaf_file(tmp_path, "['w']")
        data = bytearray(open(fpath, "rb").read())
        data[-4] ^= 0xFF  # corrupt payload, header stays parseable
        open(fpath, "wb").write(bytes(data))
        with pytest.raises(CheckpointError, match=r"\['w'\]"):
            cm.restore(_tree())

    def test_truncated_leaf_named(self, tmp_path):
        cm = _save(tmp_path)
        fpath = _leaf_file(tmp_path, "['b']")
        data = open(fpath, "rb").read()
        open(fpath, "wb").write(data[: len(data) // 2])
        with pytest.raises(CheckpointError, match=r"\['b'\]"):
            cm.restore(_tree())

    def test_missing_leaf_file_named(self, tmp_path):
        cm = _save(tmp_path)
        os.remove(_leaf_file(tmp_path, "['w']"))
        with pytest.raises(CheckpointError,
                           match=r"missing the data file.*\['w'\]"):
            cm.restore(_tree())

    def test_torn_manifest(self, tmp_path):
        cm = _save(tmp_path)
        mpath = os.path.join(tmp_path, "step_0", "manifest.json")
        data = open(mpath).read()
        open(mpath, "w").write(data[: len(data) // 2])
        with pytest.raises(CheckpointError, match="manifest"):
            cm.restore(_tree())

    def test_legacy_manifest_without_checksums(self, tmp_path):
        cm = _save(tmp_path)
        manifest = _manifest(tmp_path)
        for leaf in manifest["leaves"]:
            del leaf["sha256"]
        with open(os.path.join(tmp_path, "step_0", "manifest.json"),
                  "w") as f:
            json.dump(manifest, f)
        tree, step, _ = cm.restore(_tree())
        assert torch.equal(tree["b"], _tree()["b"])


def _model_state():
    """A reduced Qwen's seeded f32 params and a non-trivial AdamW state,
    as numpy (the reference's tree) and as tensors (the port's)."""
    cfg_ref, _ = configs("qwen1.5-4b")
    npp = np_params(cfg_ref)
    rng = np.random.default_rng(0)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), npp)
    v = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(
        np.float32), npp)
    ref_tree = {"params": npp,
                "opt": {"m": m, "v": v, "count": np.int32(7)}}
    port_tree = {"params": params_from_numpy(npp, device="cpu"),
                 "opt": {"m": params_from_numpy(m, device="cpu"),
                         "v": params_from_numpy(v, device="cpu"),
                         "count": torch.tensor(7, dtype=torch.int32)}}
    return ref_tree, port_tree


def test_state_keys_are_the_reference_optimizers():
    ref_tree, port_tree = _model_state()
    rs = ref_adamw().init(jax.tree.map(jnp.asarray, ref_tree["params"]))
    ts = adamw().init(port_tree["params"])
    assert [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(rs)[0]] == \
        [p for p, _ in leaves_with_path(ts)]


def test_reference_writes_port_restores(tmp_path):
    ref_tree, port_tree = _model_state()
    RefManager(str(tmp_path), async_save=False).save(
        3, ref_tree, metadata={"loss": 1.5})
    tree, step, meta = CheckpointManager(str(tmp_path)).restore(
        _zeros_like(port_tree))
    assert step == 3 and meta == {"loss": 1.5}
    for (path, a), b in zip(leaves_with_path(tree), leaves(port_tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_port_writes_reference_restores(tmp_path):
    ref_tree, port_tree = _model_state()
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, port_tree, metadata={"loss": 2.5})  # async
    cm.wait()
    target = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype),
        ref_tree)
    tree, step, meta = RefManager(str(tmp_path)).restore(target)
    assert step == 5 and meta == {"loss": 2.5}
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = dict(leaves_with_path(port_tree))
    assert sorted(jax.tree_util.keystr(p) for p, _ in got) == sorted(want)
    for p, a in got:
        b = want[jax.tree_util.keystr(p)]
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def test_bf16_leaves_roundtrip_as_bits(tmp_path):
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    tree = {"w": x, "n": torch.tensor(3, dtype=torch.int32)}
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, tree)
    entry = next(leaf for leaf in _manifest(tmp_path, 1)["leaves"]
                 if leaf["path"] == "['w']")
    assert entry["dtype"] == "bfloat16"
    on_disk = np.load(_leaf_file(tmp_path, "['w']", 1))
    assert on_disk.dtype == np.uint16
    back, _, _ = cm.restore(_zeros_like(tree))
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], x)
    assert torch.equal(back["n"], tree["n"])


def test_save_copies_at_save_time_and_keeps_the_newest(tmp_path):
    """An async save holds the values of its call even if the tree
    changes at once; ``keep`` steps survive; restore takes the newest."""
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in range(4):
        cm.save(step, tree)
        tree["b"].add_(1.0)  # the trainer updates in place right after
    cm.wait()
    assert cm.all_steps() == [2, 3] and cm.latest_step() == 3
    back, step, _ = cm.restore(_zeros_like(_tree()))
    assert step == 3 and torch.equal(back["b"], torch.full((4,), 4.0))
    back2, _, _ = cm.restore(_zeros_like(_tree()), step=2)
    assert torch.equal(back2["b"], torch.full((4,), 3.0))
    assert not any(n.startswith(".tmp") for n in os.listdir(tmp_path))
