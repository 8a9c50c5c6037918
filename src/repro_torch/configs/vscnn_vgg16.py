"""VGG-16 on the vector-sparse datapath, the paper's own evaluation network
(the port of `repro/configs/vscnn_vgg16.py`), simulated on the paper's two
168-PE configurations of §IV (``pe_configs``, counted by
`core.accel_model`) beside the paper's reported points for them
(``paper_speedup``, ``paper_frac_ideal_vector``, ``paper_frac_ideal_fine``).

Classic VGG: 13 3x3 convs with ReLU and no BN, five 2x2 max-pools, a
Flatten head and three FCs (`models.graph.build_vgg16`), vector-pruned to
the paper's 23.5% density.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.accel_model import PE_4_14_3, PE_8_7_3, PEConfig
from repro_torch.models.graph import SparseNet


@dataclasses.dataclass(frozen=True)
class VSCNNConfig:
    name: str = "vscnn-vgg16"
    modality: str = "cnn"           # servable arch: image requests, not tokens
    image_size: int = 224
    num_classes: int = 1000
    weight_density: float = 0.235   # paper: 23.5% after vector pruning
    vk: int = 32                    # kernel vector length (K-tile)
    vn: int = 128                   # output strip width
    # the Flatten head ties fc1's fan-in to image_size: serving batches must
    # pad every image up to exactly (image_size, image_size)
    fixed_image_size: bool = True
    pe_configs: tuple[PEConfig, ...] = (PE_4_14_3, PE_8_7_3)
    # paper-reported reference points (Figs 12/13, §IV), one per PE config
    paper_speedup: tuple[float, ...] = (1.871, 1.93)
    paper_frac_ideal_vector: tuple[float, ...] = (0.92, 0.85)
    paper_frac_ideal_fine: tuple[float, ...] = (0.466, 0.471)

    def reduce(self) -> "VSCNNConfig":
        return dataclasses.replace(self, image_size=32, num_classes=16)

    def build(self) -> SparseNet:
        """The servable network: `models.graph.SparseNet` for this config."""
        from repro_torch.models.graph import build_vgg16
        return build_vgg16(self.num_classes, image_size=self.image_size)


CONFIG = VSCNNConfig()
