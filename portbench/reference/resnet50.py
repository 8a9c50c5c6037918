"""ResNet-50 v1.5 (He et al., arXiv:1512.03385, Table 1, 50-layer; the
v1.5 variant of MLPerf Inference strides the 3x3 conv of each stage's
first block) in plain PyTorch: a 7x7/2 conv with BN and ReLU, a 3x3/2 max
pool (SAME), four stages of (3, 4, 6, 3) bottleneck blocks of widths 64,
128, 256 and 512 (1x1 -> 3x3 -> 1x1, expansion 4, BN throughout; a 1x1
BN projection where the shape changes), global average pooling and the
classifier.  The shortcut is added after the last BN and before its ReLU.
"""
from __future__ import annotations

import torch

from portbench.reference.common import Layer, conv, fc, max_pool_same, out_size

STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))


def _blocks():
    cin = 64
    for si, (c, n) in enumerate(STAGES):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            yield f"layer{si + 1}_{bi}", cin, c, stride
            cin = 4 * c


def layer_table(image_size: int, num_classes: int) -> list[Layer]:
    s = out_size(image_size, 2)
    layers = [Layer("conv1", "conv", 3, 64, 7, 7, 2, bn=True,
                    h_in=image_size, w_in=image_size, h_out=s, w_out=s)]
    s = out_size(s, 2)   # the max pool
    for pre, cin, c, stride in _blocks():
        so = out_size(s, stride)
        if stride != 1 or cin != 4 * c:
            layers.append(Layer(f"{pre}_down", "conv", cin, 4 * c, 1, 1,
                                stride, bn=True, relu=False, h_in=s, w_in=s,
                                h_out=so, w_out=so))
        layers += [
            Layer(f"{pre}_conv1", "conv", cin, c, 1, 1, 1, bn=True,
                  h_in=s, w_in=s, h_out=s, w_out=s),
            Layer(f"{pre}_conv2", "conv", c, c, 3, 3, stride, bn=True,
                  h_in=s, w_in=s, h_out=so, w_out=so),
            Layer(f"{pre}_conv3", "conv", c, 4 * c, 1, 1, 1, bn=True,
                  residual=True, h_in=so, w_in=so, h_out=so, w_out=so),
        ]
        s = so
    layers.append(Layer("fc", "fc", 2048, num_classes, relu=False))
    return layers


def forward(layers: list[Layer], prep: dict, x: torch.Tensor
            ) -> torch.Tensor:
    """x (N, 3, H, W) -> logits (N, classes)."""
    by = {l.name: l for l in layers}
    x = conv(x, prep["conv1"], by["conv1"])
    x = max_pool_same(x, 3, 2)
    for pre, _, _, _ in _blocks():
        down = by.get(f"{pre}_down")
        sc = x if down is None else conv(x, prep[down.name], down)
        y = conv(x, prep[f"{pre}_conv1"], by[f"{pre}_conv1"])
        y = conv(y, prep[f"{pre}_conv2"], by[f"{pre}_conv2"])
        x = conv(y, prep[f"{pre}_conv3"], by[f"{pre}_conv3"], residual=sc)
    x = x.mean(dim=(2, 3))
    return fc(x, prep["fc"], by["fc"])
