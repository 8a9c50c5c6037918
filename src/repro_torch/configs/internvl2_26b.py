"""InternVL2-26B backbone: the InternLM2-20B language model
[arXiv:2404.16821].

The port of `repro/configs/internvl2_26b.py`, field for field.  48
layers, d_model 6144, 48 heads of 128 over 8 KV heads, SwiGLU d_ff
16384, vocab 92553 padded to 94208: about 19.3 B parameters.  The
InternViT frontend is a stub, as in the reference: the inputs are
precomputed patch embeddings (``embed_inputs=False``, `models.frontend`).
"""
from .base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    segments=(Segment(48, (LayerSpec("attn", "mlp"),)),),
    activation="swiglu",
    embed_inputs=False,
    microbatches=16,
    attn_sharding="heads",
    notes="vision frontend stubbed: inputs are precomputed patch embeddings",
)
