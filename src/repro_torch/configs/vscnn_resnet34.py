"""ResNet-34 on the vector-sparse datapath (the port of
`repro/configs/vscnn_resnet34.py`; ``pe_configs`` are the paper's two
168-PE arrays that `core.accel_model` counts cycles on).

ResNet-18's basic blocks at ResNet-50's stage depths: no conv geometry
that the kernels do not already run, so the config is a plan and a
registry entry (`models.graph.build_resnet34`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.accel_model import PE_4_14_3, PE_8_7_3, PEConfig
from repro_torch.models.graph import SparseNet


@dataclasses.dataclass(frozen=True)
class VSCNNResNet34Config:
    name: str = "vscnn-resnet34"
    modality: str = "cnn"           # servable arch: image requests, not tokens
    image_size: int = 224
    num_classes: int = 1000
    weight_density: float = 0.235   # the paper's vector-pruning operating point
    vk: int = 32                    # kernel vector length (K-tile)
    vn: int = 128                   # output strip width
    # GAP head: geometry is size-agnostic, so serving buckets pad images to
    # the nearest shape bucket instead of one fixed size
    fixed_image_size: bool = False
    pe_configs: tuple[PEConfig, ...] = (PE_4_14_3, PE_8_7_3)

    def reduce(self) -> "VSCNNResNet34Config":
        # num_classes=200 keeps a non-tileable head (200 % 128 != 0): the
        # FC remainder strip stays exercised even in the reduced config.
        return dataclasses.replace(self, image_size=32, num_classes=200)

    def build(self) -> SparseNet:
        """The servable network: `models.graph.SparseNet` for this config."""
        from repro_torch.models.graph import build_resnet34
        return build_resnet34(self.num_classes, image_size=self.image_size)


CONFIG = VSCNNResNet34Config()
