"""Qwen1.5-4B: QKV bias, MHA (kv == heads == 20) [hf:Qwen/Qwen1.5-4B].

The port of `repro/configs/qwen15_4b.py`, field for field.  40 layers,
d_model 2560, head_dim 128, SwiGLU d_ff 6912, vocab 151936 padded to
153600, bf16 weights and caches: about 3.96 B parameters.
"""
from .base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    segments=(Segment(40, (LayerSpec("attn", "mlp"),)),),
    activation="swiglu",
    qkv_bias=True,
    microbatches=4,
    attn_sharding="sp",
)
