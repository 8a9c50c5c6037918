"""Phi-3-medium 14B: RoPE + SwiGLU + GQA (40H, kv=10) [arXiv:2404.14219].

The port of `repro/configs/phi3_medium_14b.py`, field for field.  40
layers, d_model 5120, head_dim 128, SwiGLU d_ff 17920, vocab 100352,
bf16 weights and caches: about 14.7 B parameters (29.3 GB).
"""
from .base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    segments=(Segment(40, (LayerSpec("attn", "mlp"),)),),
    activation="swiglu",
    microbatches=8,
    attn_sharding="sp",
)
