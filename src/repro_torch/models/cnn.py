"""VGG-16 / ResNet-stem entry points: thin shims over `models.graph`.

The port of `repro/models/cnn.py`, the PR-1-era entry points kept as
delegations to the graph API (`graph.build_vgg16`, `build_resnet_stem`,
`net_apply`, `sparsify`): `vgg16_apply`, `sparsify_vgg16`,
`resnet_stem_apply`, ... run the same executor, with its kernels (the
vector-sparse conv and FC kernels where ``sparse`` holds a layer, dense
otherwise).  New code should target the graph API directly.
"""
from __future__ import annotations

from typing import Any

import torch

from .graph import (  # noqa: F401  (re-exported layer-level helpers)
    SparseConv,
    SparseFC,
    VGG16_LAYERS,
    apply_sparse_conv,
    apply_sparse_fc,
    build_resnet_stem,
    build_vgg16,
    net_apply,
    sparse_conv_from_dense,
    sparsify,
)

__all__ = [
    "VGG16_LAYERS", "vgg16_schema", "vgg16_apply", "sparsify_vgg16",
    "SparseConv", "sparse_conv_from_dense", "apply_sparse_conv",
    "RESNET_STEM_LAYERS", "resnet_stem_schema", "resnet_stem_apply",
    "sparsify_resnet_stem", "collect_conv_traffic", "conv_names",
]

# Layer names and geometry do not depend on the size: one net serves every
# image_size / num_classes at apply time (dims matter only for the schema).
_VGG16_NET = build_vgg16()
_STEM_NET = build_resnet_stem()

# (name, kh, kw, stride, cin, cout), as the reference keeps it
RESNET_STEM_LAYERS = tuple(
    (l.name, l.kh, l.kw, l.stride, l.cin, l.cout)
    for l in _STEM_NET.conv_layers()
)


def conv_names() -> list:
    """[(name, cin, cout)] of VGG-16's 13 convs."""
    return [(l.name, l.cin, l.cout) for l in _VGG16_NET.conv_layers()]


def vgg16_schema(num_classes: int = 1000, *, image_size: int = 224) -> dict:
    return build_vgg16(num_classes, image_size=image_size).schema()


def vgg16_apply(params: dict, x: torch.Tensor, *, sparse: dict | None = None,
                impl: str = "auto", collect: list | None = None
                ) -> torch.Tensor:
    """x (N, H, W, 3) -> logits (N, classes): `graph.net_apply` of
    VGG-16.  ``collect`` gets (name, conv input, weight) triples."""
    rec = [] if collect is not None else None
    out = net_apply(_VGG16_NET, params, x, sparse=sparse, impl=impl,
                    collect=rec)
    if collect is not None:
        collect.extend((n, xi, w) for n, xi, w, *_ in rec)
    return out


def sparsify_vgg16(params: dict, density: float, *, vk: int = 32,
                   vn: int = 128, include_fc: bool = True
                   ) -> tuple[dict, dict]:
    """Vector-prune VGG-16 to ``density``: `graph.sparsify` (the FC layers
    whose Cout does not tile run sparse through a remainder strip)."""
    return sparsify(_VGG16_NET, params, density, vk=vk, vn=vn,
                    include_fc=include_fc)


def resnet_stem_schema() -> dict:
    return _STEM_NET.schema()


def resnet_stem_apply(params: dict, x: torch.Tensor, *,
                      sparse: dict | None = None, impl: str = "auto"
                      ) -> torch.Tensor:
    """x (N, H, W, 3) -> (N, H/4, W/4, 128) feature map, ReLU after each
    conv."""
    return net_apply(_STEM_NET, params, x, sparse=sparse, impl=impl)


def sparsify_resnet_stem(params: dict, density: float, *, vk: int = 32,
                         vn: int = 128) -> tuple[dict, dict]:
    """Vector-prune the ResNet-style stem; as `sparsify_vgg16`."""
    return sparsify(_STEM_NET, params, density, vk=vk, vn=vn)


def collect_conv_traffic(params: dict, x: torch.Tensor) -> list:
    """A VGG-16 forward recording (name, conv input NHWC, weight) per conv
    layer."""
    rec: list[Any] = []
    vgg16_apply(params, x, collect=rec)
    return rec
