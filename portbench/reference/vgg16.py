"""VGG-16, configuration D of Simonyan & Zisserman (arXiv:1409.1556,
Table 1), in plain PyTorch: 13 3x3/1 convs with ReLU and no BN, a 2x2
max-pool after each of the five blocks, then fc1 and fc2 (4096, ReLU) and
the classifier.  fc1's rows follow the flattened (H, W, C) order of the
last pool's output.
"""
from __future__ import annotations

import torch

from portbench.reference.common import Layer, conv, fc

PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512, "M")


def layer_table(image_size: int, num_classes: int) -> list[Layer]:
    layers, cin, size, i = [], 3, image_size, 1
    for c in PLAN:
        if c == "M":
            size //= 2
            continue
        layers.append(Layer(f"conv{i}", "conv", cin, c, 3, 3, 1,
                            h_in=size, w_in=size, h_out=size, w_out=size))
        cin, i = c, i + 1
    fc_in = 512 * (image_size // 32) ** 2
    layers += [Layer("fc1", "fc", fc_in, 4096),
               Layer("fc2", "fc", 4096, 4096),
               Layer("fc3", "fc", 4096, num_classes, relu=False)]
    return layers


def forward(layers: list[Layer], prep: dict, x: torch.Tensor
            ) -> torch.Tensor:
    """x (N, 3, H, W) -> logits (N, classes)."""
    by = {l.name: l for l in layers}
    i = 1
    for c in PLAN:
        if c == "M":
            x = torch.nn.functional.max_pool2d(x, 2, 2)
        else:
            name = f"conv{i}"
            x = conv(x, prep[name], by[name])
            i += 1
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for name in ("fc1", "fc2", "fc3"):
        x = fc(x, prep[name], by[name])
    return x
