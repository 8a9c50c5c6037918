"""The system under test: the port's one-replica CNN serving path.

`Program` composes it as ``CNNServer.__init__`` does for one replica:
vscheck's gate (`validate_net`), then `SparseNet.sparsify` of the dense
weights, a `CNNBackend` and a `LockstepScheduler` of the configured
width.  It is built here, not through `CNNServer`, so that the program
serves the weights this benchmark made from ``--seed``.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any

import torch

__all__ = ["Program", "port_config"]


def port_config(config: dict) -> Any:
    """The port's registered config (``config["arch"]``) with this file's
    sizes put in."""
    from repro_torch.configs import get_config
    keys = ("image_size", "num_classes", "weight_density", "vk", "vn")
    return dataclasses.replace(get_config(config["arch"]),
                               **{k: config[k] for k in keys})


class Program:
    """The served path of one configuration on ``device``."""

    def __init__(self, config: dict, params: dict, device: Any):
        from repro_torch.launch.scheduler import LockstepScheduler
        from repro_torch.launch.serve import CNNBackend, validate_net

        cfg = port_config(config)
        self.net = cfg.build()
        validate_net(self.net, cfg.image_size, density=cfg.weight_density,
                     vk=cfg.vk, vn=cfg.vn)
        dtype = None if config["dtype"] == "f32" else config["dtype"]
        sparse, _ = self.net.sparsify(params, cfg.weight_density, vk=cfg.vk,
                                      vn=cfg.vn, dtype=dtype)
        self.backend = CNNBackend(
            self.net, params, sparse=sparse, impl=config["impl"],
            density=cfg.weight_density,
            image_size=cfg.image_size if cfg.fixed_image_size else None,
            device=device)
        self.scheduler = LockstepScheduler(self.backend,
                                           batch=config["width"])

    def schema(self) -> dict:
        """{layer: {leaf: shape}} of the port's net."""
        return {layer: {leaf: tuple(p.shape) for leaf, p in leaves.items()}
                for layer, leaves in self.net.schema().items()}

    def requests(self, images: list, first_rid: int) -> list:
        from repro_torch.launch.serve import ImageRequest
        return [ImageRequest(rid=first_rid + i, image=im)
                for i, im in enumerate(images)]

    def serve(self, requests: list) -> list[dict]:
        """One `LockstepScheduler.serve` call; each delivered request
        carries its logits (``.logits``) and its outcome."""
        return self.scheduler.serve(requests)

    @property
    def compiles(self) -> int:
        """Shape buckets built (on the card: CUDA graphs captured)."""
        return self.backend.apply.compiles

    def close(self) -> None:
        """Drop the program's state (weights, graphs, memory pool)."""
        self.backend = self.scheduler = self.net = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
