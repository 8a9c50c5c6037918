"""Architecture registry of the port: the CNN configs it can serve.

Holds only ResNet-18 in this slice; VGG-16, ResNet-34/50 and MobileNetV1
join as their slices land.
"""
from __future__ import annotations

from typing import Any

from . import vscnn_resnet18

__all__ = ["CNN_REGISTRY", "get_config", "list_cnn_archs"]

CNN_REGISTRY = {m.CONFIG.name: m.CONFIG for m in [vscnn_resnet18]}


def get_config(name: str) -> Any:
    if name in CNN_REGISTRY:
        return CNN_REGISTRY[name]
    raise KeyError(f"unknown arch {name!r}; have {sorted(CNN_REGISTRY)}")


def list_cnn_archs() -> list[str]:
    """CNN serving archs (image-input, `CNNServer`-servable)."""
    return sorted(CNN_REGISTRY)
