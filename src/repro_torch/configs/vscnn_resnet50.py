"""ResNet-50 on the vector-sparse datapath (the port of
`repro/configs/vscnn_resnet50.py`, without the accelerator cycle model's PE
configurations, which stay with that model).

The reference's headline benchmark, shared with SCNN.  The bottleneck
block (1x1 reduce -> 3x3 -> 1x1 expand, 4x expansion) runs on the kernels
the port already has (`models.graph.build_resnet50`): BN folds into the
conv weights at sparsify time and every shortcut rides the expand conv's
fused epilogue in `vsmm`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.graph import SparseNet


@dataclasses.dataclass(frozen=True)
class VSCNNResNet50Config:
    name: str = "vscnn-resnet50"
    modality: str = "cnn"           # servable arch: image requests, not tokens
    image_size: int = 224
    num_classes: int = 1000
    weight_density: float = 0.235   # the paper's vector-pruning operating point
    vk: int = 32                    # kernel vector length (K-tile)
    vn: int = 128                   # output strip width
    # GAP head: geometry is size-agnostic, so serving buckets pad images to
    # the nearest shape bucket instead of one fixed size
    fixed_image_size: bool = False

    def reduce(self) -> "VSCNNResNet50Config":
        # num_classes=200 keeps a non-tileable head (200 % 128 != 0): the
        # FC remainder strip stays exercised even in the reduced config.
        return dataclasses.replace(self, image_size=32, num_classes=200)

    def build(self) -> SparseNet:
        """The servable network: `models.graph.SparseNet` for this config."""
        from repro_torch.models.graph import build_resnet50
        return build_resnet50(self.num_classes, image_size=self.image_size)


CONFIG = VSCNNResNet50Config()
