"""Nemotron-4 340B: GQA, squared-ReLU MLP [arXiv:2402.16819].

The port of `repro/configs/nemotron_4_340b.py`, field for field.  96
layers, d_model 18432, 96 heads of 192 over 8 KV heads, relu2 d_ff
73728, vocab 256000: about 341 B parameters, so one card holds it only
at reduced depth.
"""
from .base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    segments=(Segment(96, (LayerSpec("attn", "mlp"),)),),
    activation="relu2",
    microbatches=16,
    grad_accum_dtype="bfloat16",
    attn_sharding="heads",
    optimizer="adafactor",
)
