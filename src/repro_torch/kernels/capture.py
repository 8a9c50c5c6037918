"""CUDA graphs around the kernels: capture once, replay, count true.

The port's counterpart of the reference's jit layer, which keeps one
compiled executable per input shape: a `torch.cuda.CUDAGraph`
holds every launch of one call (the hand-written kernels, which `launch`
puts on the current stream, and PyTorch's own), and a replay runs them
again with no Python and no per-launch host cost.

Each kernel wrapper adds one to its counters (``launches``, and
``stem_launches`` / ``int8_launches`` where it has them) where it
launches, and a replay never reaches the wrappers.  So `capture` records
what the captured call added to each counter and takes it back (a
capture runs nothing on the device), and `Captured.replay` adds it again
each time the device runs the graph.  The warm-up before a capture runs
eagerly and counts as it runs: a new graph's first call runs, and
counts, its launches twice (the warm-up and the first replay).

Only CUDA tensors are captured.  A capture that fails raises: callers
have no eager fallback on the card.  Destroying a graph (or an event or
page-locked memory) while another is being captured invalidates that
capture, and a dead server's graphs can sit in a reference cycle (a
replica fault's traceback holds the fleet's frames) until the garbage
collector runs: `capture` holds the collector off while it captures.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Any, Callable

import torch

__all__ = ["COUNTERS", "wrappers", "counts", "add_counts", "Captured",
           "capture", "no_collection"]

COUNTERS = ("launches", "stem_launches", "int8_launches")


def wrappers() -> dict:
    """Every kernel wrapper, by kernel name: the one registry of the
    counters that `capture` records and `Captured.replay` adds."""
    from repro_torch.kernels.flash import flash_fwd_kernel
    from repro_torch.kernels.vsconv import (vsconv_halo_kernel,
                                            vsconv_stack_kernel)
    from repro_torch.kernels.vsconv_dw import (vsconv_dw_halo_kernel,
                                               vsconv_dw_stack_kernel)
    from repro_torch.kernels.vsmm import vsmm_kernel
    return {"vsconv_halo": vsconv_halo_kernel, "vsmm": vsmm_kernel,
            "vsconv_dw_halo": vsconv_dw_halo_kernel,
            "vsconv_stack": vsconv_stack_kernel,
            "vsconv_dw_stack": vsconv_dw_stack_kernel,
            "flash_fwd": flash_fwd_kernel}


def counts() -> dict:
    """Every counter of every kernel wrapper: {(wrapper, counter): n}."""
    return {(w, name): getattr(w, name) for w in wrappers().values()
            for name in COUNTERS if hasattr(w, name)}


def add_counts(delta: dict) -> None:
    """Add ``delta`` ({(wrapper, counter): n}) to the wrappers' counters."""
    for (w, name), n in delta.items():
        setattr(w, name, getattr(w, name) + n)


@dataclasses.dataclass
class Captured:
    """A captured graph and the counts one run of it adds (``launches``,
    {(wrapper, counter): n}); ``replays`` counts its replays."""

    graph: Any                   # torch.cuda.CUDAGraph: anything with replay()
    launches: dict
    replays: int = 0

    def replay(self) -> None:
        self.graph.replay()
        add_counts(self.launches)
        self.replays += 1


@contextlib.contextmanager
def no_collection() -> Any:
    """Keep the garbage collector off until the block ends: no dead graph
    in a reference cycle is destroyed during a capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def capture(fn: Callable[[], Any], *, pool: Any = None
            ) -> tuple[Captured, Any]:
    """Run ``fn`` once eagerly on a side stream (the warm-up: kernels are
    built, plans made, PyTorch's libraries set up), then capture one call
    of it into a new graph in memory pool ``pool`` (None: a pool of its
    own).  Returns the graph and what the captured call returned: static
    tensors that every replay rewrites.  ``fn`` must read its inputs from
    tensors that outlive the graph and must not wait on the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = counts()
    try:
        with no_collection(), torch.cuda.graph(graph, pool=pool):
            out = fn()
    finally:
        after = counts()
        add_counts({k: before[k] - n for k, n in after.items()})
    return Captured(graph, {k: n - before[k] for k, n in after.items()
                            if n != before[k]}), out
