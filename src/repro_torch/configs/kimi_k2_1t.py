"""Kimi K2 — trillion-parameter MoE: 61 layers (first dense, 60 MoE),
384 experts top-8 + 1 shared expert, expert d_ff 2048 [paper-table].

The port of `repro/configs/kimi_k2_1t.py`, field for field.  The dense
stem layer's d_ff is 18432; each MoE layer holds 384 experts of d_ff
2048 plus a shared SwiGLU expert of the same width (``ffn_shared``).
About 1.03 T parameters: one card holds the stem and one MoE layer.
"""
from repro_torch.models.moe import MoEConfig

from .base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=18432,  # the single dense stem layer
    vocab=163840,
    segments=(
        Segment(1, (LayerSpec("attn", "mlp"),)),
        Segment(60, (LayerSpec("attn", "moe"),)),
    ),
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared=1),
    activation="swiglu",
    microbatches=8,
    grad_accum_dtype="bfloat16",
    attn_sharding="heads",
    optimizer="adafactor",
)
