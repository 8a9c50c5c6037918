"""Batched CNN serving: `net_apply` behind the lockstep scheduler.

The port of `repro/launch/serve.py`'s CNN arm with one replica:

* `CNNBackend` — requests carry images, batches pad/bucket on image shape,
  every request finishes in one lockstep step, and freed slots are refilled
  from the queue so one batch shape serves wave after wave; a partial final
  wave shrinks to its occupied slots (pow2 ladder) instead of computing
  zero images.  ``step`` is split into ``dispatch`` (build the batch on the
  device and enqueue the forward — CUDA launches return before the card
  finishes) and ``collect`` (copy the logits to the host, which waits).
* `CNNServer` — builds the net from a config, makes seeded params,
  sparsifies them and serves through a `LockstepScheduler`.  It runs on
  CUDA unless ``device="cpu"``; ``impl="auto"`` takes the CUDA kernels on
  the card and the plain path on the CPU.

The replica fleet, sharded heads, chaos injection and the LM arm come in
later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.launch.scheduler import LockstepScheduler
from repro_torch.models.graph import BatchedApply, SparseNet, input_refusal
from repro_torch.models.layers import init_params

__all__ = ["ImageRequest", "CNNBackend", "CNNServer"]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass
class ImageRequest:
    """One CNN inference request."""

    rid: int
    image: np.ndarray            # (H, W, C) float
    max_new: int = 1             # one-shot: a single emission finishes it
    out: list = dataclasses.field(default_factory=list)  # [predicted class]
    logits: np.ndarray | None = None
    outcome: Any = None          # the scheduler's RequestOutcome


class CNNBackend:
    """One-shot image backend: a request finishes in a single lockstep step.

    ``image_size`` pins the bucket to the net's fixed input; when None the
    bucket pads each image's H/W up to ``pad_multiple`` (size-agnostic nets
    like the GAP-headed ResNets).  A partial wave computes on a batch
    shrunk to the occupied slots, rounded up to the next power of two and
    capped at the full width, so a shape bucket sees at most
    log2(width)+1 batch shapes.
    """

    def __init__(self, net: SparseNet, params: dict, *,
                 sparse: dict | None = None, impl: str = "auto",
                 density: float | None = None, image_size: int | None = None,
                 pad_multiple: int = 8,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.pad_multiple = pad_multiple
        self.channels = next((l.cin for l in net.conv_layers()), None)
        self.apply = BatchedApply(net, params, sparse=sparse, impl=impl,
                                  key=(density,))

    # -- scheduler protocol -------------------------------------------------

    def validate_request(self, req: ImageRequest) -> str | None:
        """Admission-time validation: malformed images (wrong type, rank,
        dtype, channels, non-finite values, oversize for a fixed-input net)
        become structured refusals."""
        return input_refusal(req.image, max_size=self.image_size,
                             channels=self.channels)

    def bucket_key(self, req: ImageRequest) -> tuple[int, int, int]:
        h, w, c = req.image.shape
        if self.image_size is not None:
            if max(h, w) > self.image_size:
                raise ValueError(
                    f"image {h}x{w} exceeds the net's fixed input size "
                    f"{self.image_size}")
            return (self.image_size, self.image_size, c)
        m = self.pad_multiple
        return (_round_up(h, m), _round_up(w, m), c)

    def sort_key(self, req: ImageRequest) -> int:
        return req.rid  # arrival order; all images in a bucket are equal

    def start(self, requests: list[ImageRequest], width: int
              ) -> tuple[dict, None]:
        return {"width": width, "bucket": self.bucket_key(requests[0])}, None

    def dispatch(self, state: dict, slots: list
                 ) -> tuple[list[int], torch.Tensor]:
        """Issue one wave: pad the occupied slots into a batch, copy it to
        the device and enqueue the forward.  The returned logits may still
        be in flight — `collect` waits for them."""
        hb, wb, c = state["bucket"]
        occ = [j for j, r in enumerate(slots) if r is not None]
        nb = min(state["width"], 1 << max(len(occ) - 1, 0).bit_length())
        x = np.zeros((nb, hb, wb, c), np.float32)
        for i, j in enumerate(occ):
            h, w, _ = slots[j].image.shape
            x[i, :h, :w] = slots[j].image
        return occ, self.apply(torch.from_numpy(x).to(self.device))

    def collect(self, state: dict, handle: tuple[list[int], torch.Tensor],
                slots: list) -> tuple[dict, list]:
        occ, y_dev = handle
        y = y_dev.cpu().numpy()
        emis: list = [None] * state["width"]
        for i, j in enumerate(occ):
            emis[j] = y[i]
        return state, emis

    def step(self, state: dict, slots: list) -> tuple[dict, list]:
        return self.collect(state, self.dispatch(state, slots), slots)

    def can_backfill(self, state: dict, req: ImageRequest) -> bool:
        return self.bucket_key(req) == state["bucket"]

    def backfill(self, state: dict, slot: int, req: ImageRequest
                 ) -> tuple[dict, None]:
        return state, None  # computed on the next lockstep step

    def append(self, req: ImageRequest, logits: np.ndarray) -> bool:
        req.logits = np.asarray(logits)
        req.out.append(int(req.logits.argmax()))
        return True

    def finish(self, state: dict) -> dict:
        return {"compiles": self.apply.compiles}


class CNNServer:
    """Batched CNN serving: `net_apply` behind the lockstep scheduler.

    ``cfg`` is a config from `repro_torch.configs`: ``cfg.build()`` gives the
    `SparseNet`, ``cfg.weight_density`` the default pruning point.  Params
    are initialized from ``seed`` and sparsified at f32; ``sparse=False``
    serves the dense path.
    """

    def __init__(self, cfg: Any, *, batch: int, impl: str = "auto",
                 density: float | None = None, sparse: bool = True,
                 seed: int = 0, pad_multiple: int = 8,
                 max_queue: int | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.net = cfg.build()
        self.density = cfg.weight_density if density is None else density
        self.params = init_params(self.net.schema(), seed,
                                  device=self.device)
        self.sparse = None
        if sparse:
            self.sparse, _ = self.net.sparsify(
                self.params, self.density, vk=cfg.vk, vn=cfg.vn)
        self.backend = CNNBackend(
            self.net, self.params, sparse=self.sparse, impl=impl,
            density=self.density if sparse else None,
            image_size=cfg.image_size if cfg.fixed_image_size else None,
            pad_multiple=pad_multiple, device=self.device)
        self.scheduler = LockstepScheduler(self.backend, batch=batch,
                                           max_queue=max_queue)

    @property
    def outcomes(self) -> dict:
        """Per-request terminal outcomes of the last `serve` call."""
        return self.scheduler.outcomes

    def serve(self, requests: list[ImageRequest]) -> list[dict]:
        stats = self.scheduler.serve(list(requests))
        for s in stats:
            s["images"] = s.pop("emissions")
            s["images_per_s"] = s["images"] / max(s["run_s"], 1e-9)
        return stats
