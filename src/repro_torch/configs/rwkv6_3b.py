"""RWKV-6 "Finch" 3B: attention-free, data-dependent decay
[arXiv:2404.05892].

The port of `repro/configs/rwkv6_3b.py`, field for field.  32 layers of
time mix (16 heads of 160) and squared-ReLU channel mix (d_ff 8960),
d_model 2560, vocab 65536.  No attention: its caches are the recurrent
states, so a backfill prefills at the exact context length.
"""
from .base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=16,          # head_dim 160 (the reference's TP adaptation)
    n_kv_heads=16,
    d_ff=8960,
    vocab=65536,
    segments=(Segment(32, (LayerSpec("rwkv_tm", "rwkv_cm"),)),),
    activation="relu",   # unused: channel-mix is squared-ReLU internally
    attn_free=True,
    subquadratic=True,
    microbatches=8,
    attn_sharding="heads",
)
