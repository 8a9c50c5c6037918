"""ResNet-18 on the vector-sparse datapath (the port of
`repro/configs/vscnn_resnet18.py`; ``pe_configs`` are the paper's two
168-PE arrays that `core.accel_model` counts cycles on).

BN is folded into the conv weights at sparsify time and residual adds ride
the kernels' fused epilogue, so every conv and the FC head run the sparse
path end to end (`models.graph.build_resnet18`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.accel_model import PE_4_14_3, PE_8_7_3, PEConfig
from repro_torch.models.graph import SparseNet


@dataclasses.dataclass(frozen=True)
class VSCNNResNet18Config:
    name: str = "vscnn-resnet18"
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

    def reduce(self) -> "VSCNNResNet18Config":
        # num_classes=200 keeps a non-tileable head (200 % 128 != 0): the
        # FC remainder strip stays exercised even in the reduced config.
        return dataclasses.replace(self, image_size=32, num_classes=200)

    def build(self) -> SparseNet:
        """The servable network: `models.graph.SparseNet` for this config."""
        from repro_torch.models.graph import build_resnet18
        return build_resnet18(self.num_classes, image_size=self.image_size)


CONFIG = VSCNNResNet18Config()
