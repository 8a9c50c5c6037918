"""Gemma-3 12B: 5 local (1024-window) : 1 global attention, GeGLU, qk-norm,
256k vocab, tied embeddings [hf:google/gemma-3-12b-pt].

The port of `repro/configs/gemma3_12b.py`, field for field.  48 layers
(8 groups of 5 windowed + 1 global), d_model 3840, 16 heads of 240 over
8 KV heads, GeGLU d_ff 15360, vocab 262144 tied: about 11.6 B
parameters.  A windowed layer's cache holds min(capacity, 1024) slots,
addressed circularly.
"""
from .base import ArchConfig, LayerSpec, Segment

_LOCAL = LayerSpec("attn", "mlp", window=1024)
_GLOBAL = LayerSpec("attn", "mlp")

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    segments=(Segment(8, (_LOCAL,) * 5 + (_GLOBAL,)),),
    activation="geglu",
    qk_norm=True,
    tie_embeddings=True,
    subquadratic=True,
    microbatches=8,
    attn_sharding="heads",
)
