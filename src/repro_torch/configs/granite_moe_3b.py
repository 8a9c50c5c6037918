"""Granite-3.0 MoE 3B (800M active): 40 experts top-8, expert d_ff 512
[hf:ibm-granite/granite-3.0-3b-a800m-base].

The port of `repro/configs/granite_moe_3b.py`, field for field.  32
layers of attention (24 heads of 64 over 8 KV heads) and a MoE FFN whose
40 experts are padded to 48 (the dead 8 never win the router's top-8).
"""
from repro_torch.models.moe import MoEConfig

from .base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    segments=(Segment(32, (LayerSpec("attn", "moe"),)),),
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512),
    activation="swiglu",
    microbatches=4,
    attn_sharding="sp",
)
