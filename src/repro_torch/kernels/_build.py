"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the sources and flags, so an edited
kernel is rebuilt and a stale one is never loaded.  ``build/`` lies beside
this file and is git-ignored.  `build` starts one nvcc per source, all
together, and waits for them; each result is renamed into place, so two
processes building at once cannot load a half-written library.  nvcc's
output (``-Xptxas -v``: registers, shared memory and spills per kernel) is
kept beside the library (`build_log`).  `launch` calls a library's
extern "C" launch entry on the current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

__all__ = ["CSRC", "BUILD", "NVCC_FLAGS", "build", "build_log", "load",
           "library_path", "launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one nvcc each, all
    started together.  Returns nvcc's output (register and shared-memory
    use from ``-Xptxas -v``) per compiled name; raises on a failed build."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):"
                          f"\n{out}")
        else:
            tmp.with_suffix(".log").write_text(out)
            os.replace(tmp.with_suffix(".log"), target.with_suffix(".log"))
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build_log(name: str) -> str:
    """nvcc's output for the built ``csrc/<name>.cu`` (built at first
    use)."""
    build(name)
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def launch(name: str, fn: str, tensors: Sequence[torch.Tensor | None],
           ints: Sequence[int], device: torch.device) -> None:
    """Call the extern "C" launch entry ``fn`` of ``csrc/<name>.cu`` (built
    at first use) with the tensors' pointers (None -> null), the ints and
    the current stream of ``device``; raise on a CUDA error.  The caller
    has checked every shape, dtype, device and bound the kernel relies
    on."""
    entry = getattr(load(name), fn)
    if entry.argtypes is None:
        entry.argtypes = ([ctypes.c_void_p] * len(tensors)
                          + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        entry.restype = ctypes.c_int
    ptrs = [ctypes.c_void_p(None if t is None else t.data_ptr())
            for t in tensors]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(*ptrs, *ints, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{fn}: kernel launch failed: CUDA error {err}")
