"""Architecture registry of the port: the CNN configs it can serve.

Holds ResNet-18 and MobileNetV1; VGG-16 and ResNet-34/50 join as their
slices land.
"""
from __future__ import annotations

from typing import Any

from . import vscnn_mobilenet_v1, vscnn_resnet18

__all__ = ["CNN_REGISTRY", "get_config", "list_cnn_archs"]

CNN_REGISTRY = {m.CONFIG.name: m.CONFIG for m in [vscnn_resnet18,
                                                 vscnn_mobilenet_v1]}


def get_config(name: str) -> Any:
    if name in CNN_REGISTRY:
        return CNN_REGISTRY[name]
    raise KeyError(f"unknown arch {name!r}; have {sorted(CNN_REGISTRY)}")


def list_cnn_archs() -> list[str]:
    """CNN serving archs (image-input, `CNNServer`-servable)."""
    return sorted(CNN_REGISTRY)
