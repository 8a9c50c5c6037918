"""MobileNetV1 on the vector-sparse datapath (the port of
`repro/configs/vscnn_mobilenet_v1.py`; ``pe_configs`` are the paper's
two 168-PE arrays that `core.accel_model` counts cycles on).

Every depthwise layer is a `Conv(groups=cin)` run by the per-channel tap
kernel (vk == 1 tap vectors over vn-channel tiles) and every pointwise
conv is the 1x1 sparse matmul (`models.graph.build_mobilenet_v1`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.accel_model import PE_4_14_3, PE_8_7_3, PEConfig
from repro_torch.models.graph import SparseNet


@dataclasses.dataclass(frozen=True)
class VSCNNMobileNetV1Config:
    name: str = "vscnn-mobilenet-v1"
    modality: str = "cnn"           # servable arch: image requests, not tokens
    image_size: int = 224
    num_classes: int = 1000
    # dw layers have only kh*kw tap vectors per channel tile, so the pruning
    # point is gentler than the paper's 0.235 VGG operating point: 0.5 keeps
    # 4 of a channel tile's 9 tap vectors (round(4.5))
    weight_density: float = 0.5
    vk: int = 32                    # K-tile length (pointwise convs)
    vn: int = 128                   # output strip / dw channel-tile width
    # GAP head: geometry is size-agnostic, so serving buckets pad images to
    # the nearest shape bucket instead of one fixed size
    fixed_image_size: bool = False
    pe_configs: tuple[PEConfig, ...] = (PE_4_14_3, PE_8_7_3)

    def reduce(self) -> "VSCNNMobileNetV1Config":
        # num_classes=200 keeps a non-tileable head (200 % 128 != 0): the
        # FC remainder strip stays exercised even in the reduced config.
        return dataclasses.replace(self, image_size=32, num_classes=200)

    def build(self) -> SparseNet:
        """The servable network: `models.graph.SparseNet` for this config."""
        from repro_torch.models.graph import build_mobilenet_v1
        return build_mobilenet_v1(self.num_classes,
                                  image_size=self.image_size)


CONFIG = VSCNNMobileNetV1Config()
