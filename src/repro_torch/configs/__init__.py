"""Architecture registry of the port.

Two registries share one `get_config` namespace, as the reference's do:
the LM `ArchConfig`s (`REGISTRY`, `list_archs`: Qwen1.5-4B so far) and the
CNN configs (`CNN_REGISTRY`, `list_cnn_archs`: VGG-16, ResNet-18, -34 and
-50, MobileNetV1, every CNN the reference registers).  The other LM
families join as their slices land.
"""
from __future__ import annotations

from typing import Any

from . import (qwen15_4b, vscnn_mobilenet_v1, vscnn_resnet18,
               vscnn_resnet34, vscnn_resnet50, vscnn_vgg16)

__all__ = ["REGISTRY", "CNN_REGISTRY", "get_config", "list_archs",
           "list_cnn_archs"]

REGISTRY = {m.CONFIG.name: m.CONFIG for m in [qwen15_4b]}

CNN_REGISTRY = {m.CONFIG.name: m.CONFIG for m in [
    vscnn_vgg16, vscnn_resnet18, vscnn_resnet34, vscnn_resnet50,
    vscnn_mobilenet_v1]}


def get_config(name: str) -> Any:
    if name in REGISTRY:
        return REGISTRY[name]
    if name in CNN_REGISTRY:
        return CNN_REGISTRY[name]
    raise KeyError(f"unknown arch {name!r}; have "
                   f"{sorted(REGISTRY) + sorted(CNN_REGISTRY)}")


def list_archs() -> list[str]:
    """LM (token-input) archs, `Server`-servable."""
    return sorted(REGISTRY)


def list_cnn_archs() -> list[str]:
    """CNN serving archs (image-input, `CNNServer`-servable)."""
    return sorted(CNN_REGISTRY)
