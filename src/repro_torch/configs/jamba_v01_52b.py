"""Jamba-v0.1 52B: Mamba + attention 1:7, MoE every other layer (16e
top-2) [arXiv:2403.19887].

The port of `repro/configs/jamba_v01_52b.py`, field for field.  One
block is 8 layers (attention at offset 4, MoE at the odd offsets), 4
blocks: 32 layers, d_model 4096, 16 experts of d_ff 14336.  About 52 B
parameters: one card holds one block.
"""
from repro_torch.models.moe import MoEConfig

from .base import ArchConfig, LayerSpec, Segment

_BLOCK = (
    LayerSpec("mamba", "mlp"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "mlp"),
    LayerSpec("mamba", "moe"),
    LayerSpec("attn", "mlp"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "mlp"),
    LayerSpec("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    segments=(Segment(4, _BLOCK),),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336),
    activation="swiglu",
    subquadratic=True,
    microbatches=16,
    attn_sharding="heads",
)
