"""Fault-tolerant checkpointing: atomic, async, integrity-checked restore.

The port of `repro/checkpoint/manager.py`, on its on-disk format, so a
checkpoint either side writes restores into the other (f32 and int32
leaves as they are):

  <dir>/step_<k>/ holds one .npy a leaf (``00000.npy``, ... in the
  reference's leaf order) and ``manifest.json``: each leaf's path (the
  reference's ``keystr``, ``"['params']['segments'][0]..."``), file,
  shape, dtype and sha256, the step and user metadata.

Writes go to a temp directory renamed into place, so a crash mid-save
never corrupts the latest checkpoint (restore takes the newest *complete*
step).  Restore checks every leaf's sha256 against the manifest before
using it: a corrupted, truncated or missing file, or a torn manifest,
raises `CheckpointError` naming the array.  Manifests without checksums
restore with a shape check only.

numpy has no bfloat16: a bf16 leaf goes to disk as its uint16 bits with
``"dtype": "bfloat16"`` in the manifest, and comes back as those bits.
`save` copies every leaf from the device to the host at once (the tree
may change right after), then writes in a thread unless ``block``;
`wait` joins it.  `restore` places each leaf on the device and in the
dtype of the matching leaf of ``target``.

Sharded trees (training under a mesh: DTensor leaves).  `save` gathers
each leaf whole (``full_tensor()``) on the calling thread, leaf by leaf,
on every rank, and only rank 0 keeps the host copies and writes them, in
the same format; the writer thread issues no collective (gloo and NCCL
calls from a second thread can deadlock against the main one).  `wait`
then holds every rank at a barrier until rank 0's write is published.
`restore` reads every leaf on every rank and lays it out by
``shardings`` (a matching tree of `parallel.sharding.NamedSharding`s,
the reference's elastic re-placement) or, without it, as the target's
DTensor leaf is laid out: a checkpoint of a 2x2 mesh restores on 1x4,
on 4x1 or with no mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel import sharding as shd
from repro_torch.utils.tree import leaves, leaves_with_path, tree_unflatten

__all__ = ["CheckpointManager", "CheckpointError"]

_MANIFEST = "manifest.json"


class CheckpointError(Exception):
    """A checkpoint failed its integrity check (corrupted / torn / missing
    data); the message names the offending array."""


def _sha256(fname: str) -> str:
    h = hashlib.sha256()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_host(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array to write, manifest dtype): a host copy, taken now."""
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_disk(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._sharded = False  # the last save gathered DTensors
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, metadata: dict | None = None,
             block: bool = False) -> None:
        """Snapshot ``tree`` at ``step``. Async by default; join with
        `wait`.  A tree of DTensors is gathered here, on every rank, and
        rank 0 writes it."""
        self.wait()
        sharded = any(isinstance(x, DTensor) for x in leaves(tree))
        writer = not sharded or dist.get_rank() == 0
        host = []
        for path, leaf in leaves_with_path(tree):
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()
            if writer:
                host.append((path, *_to_host(leaf)))

        def _write() -> None:
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "metadata": metadata or {},
                        "leaves": []}
            for i, (path, arr, dtype) in enumerate(host):
                fname = f"{i:05d}.npy"
                fpath = os.path.join(tmp, fname)
                np.save(fpath, arr, allow_pickle=False)
                manifest["leaves"].append(
                    {"path": path, "file": fname, "shape": list(arr.shape),
                     "dtype": dtype, "sha256": _sha256(fpath)})
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        if writer and self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        elif writer:
            _write()
        self._sharded = sharded
        if block:
            self.wait()

    def wait(self) -> None:
        """Join the writer; after a sharded save every rank meets at a
        barrier, so none reads the directory before rank 0 has published
        the step."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            dist.barrier()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, _MANIFEST)):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_leaf(self, d: str, entry: dict) -> torch.Tensor:
        """Load one leaf file with its integrity check: a missing file, a
        checksum mismatch (bit-rot / torn write) or an unparseable .npy
        raise `CheckpointError` naming the array."""
        key = entry["path"]
        fpath = os.path.join(d, entry["file"])
        if not os.path.exists(fpath):
            raise CheckpointError(
                f"checkpoint {d} is missing the data file for array {key} "
                f"({entry['file']})")
        want = entry.get("sha256")
        if want is not None:
            got = _sha256(fpath)
            if got != want:
                raise CheckpointError(
                    f"checksum mismatch for array {key} in {d}: manifest "
                    f"sha256 {want[:12]}.. but file hashes {got[:12]}.. "
                    f"(corrupted or torn checkpoint)")
        try:
            arr = np.load(fpath, allow_pickle=False)
        except (ValueError, OSError, EOFError, zlib.error) as e:
            raise CheckpointError(
                f"array {key} in {d} failed to deserialize: {e}") from e
        if list(arr.shape) != list(entry["shape"]):
            raise CheckpointError(
                f"array {key} in {d} has shape {list(arr.shape)} but the "
                f"manifest recorded {entry['shape']}")
        return _from_disk(arr, entry["dtype"])

    def restore(self, target: Any, step: int | None = None, *,
                shardings: Any = None) -> tuple[Any, int, dict]:
        """Load into the structure of ``target`` (a tree of tensors), each
        leaf on its target's device and in its dtype.  ``shardings``: an
        optional matching tree of `NamedSharding`s, each leaf laid out by
        its own on the current mesh (elastic re-placement); without it a
        DTensor target leaf gives its mesh and placements.  Every leaf is
        integrity-checked first (see `CheckpointError`).  Returns (tree,
        step, metadata)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(d, _MANIFEST)) as f:
                manifest = json.load(f)
        except json.JSONDecodeError as e:
            raise CheckpointError(
                f"manifest of {d} is not valid JSON (torn write?): {e}"
            ) from e
        by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
        tgts = leaves_with_path(target)
        places = ([None] * len(tgts) if shardings is None else leaves(
            shardings, is_leaf=lambda n: isinstance(n, shd.NamedSharding)))
        out = []
        for (key, tgt), place in zip(tgts, places):
            if key not in by_path:
                raise KeyError(f"checkpoint missing leaf {key}")
            t = self._load_leaf(d, by_path[key])
            if tuple(t.shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{tuple(t.shape)} vs target "
                                 f"{tuple(tgt.shape)}")
            t = t.to(device=tgt.device, dtype=tgt.dtype)
            if place is not None:
                t = shd.place(t, place.mesh, place.placements)
            elif isinstance(tgt, DTensor):
                t = shd.place(t, tgt.device_mesh, tuple(tgt.placements))
            out.append(t)
        return tree_unflatten(target, out), step, manifest["metadata"]
