"""Architecture registry of the port.

Two registries share one `get_config` namespace, as the reference's do:
the LM `ArchConfig`s (`REGISTRY`, `list_archs`: the reference's ten —
the eight token-input archs Gemma-3-12B, Granite-MoE-3B, Jamba-v0.1,
Kimi-K2, Nemotron-4-340B, Phi-3-medium, Qwen1.5-4B, RWKV-6-3B and the
two embedding-input ones HuBERT-XLarge and InternVL2-26B) and the CNN
configs (`CNN_REGISTRY`, `list_cnn_archs`: VGG-16, ResNet-18, -34 and
-50, MobileNetV1, every CNN the reference registers).
"""
from __future__ import annotations

from typing import Any

from . import (gemma3_12b, granite_moe_3b, hubert_xlarge, internvl2_26b,
               jamba_v01_52b, kimi_k2_1t, nemotron_4_340b, phi3_medium_14b,
               qwen15_4b, rwkv6_3b, vscnn_mobilenet_v1, vscnn_resnet18,
               vscnn_resnet34, vscnn_resnet50, vscnn_vgg16)

__all__ = ["REGISTRY", "CNN_REGISTRY", "get_config", "list_archs",
           "list_cnn_archs"]

REGISTRY = {m.CONFIG.name: m.CONFIG for m in [
    internvl2_26b, gemma3_12b, nemotron_4_340b, qwen15_4b, phi3_medium_14b,
    jamba_v01_52b, granite_moe_3b, kimi_k2_1t, hubert_xlarge, rwkv6_3b]}

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
    """LM archs: the token-input ones `Server`-servable, the
    embedding-input ones run through `models.transformer`'s entries."""
    return sorted(REGISTRY)


def list_cnn_archs() -> list[str]:
    """CNN serving archs (image-input, `CNNServer`-servable)."""
    return sorted(CNN_REGISTRY)
