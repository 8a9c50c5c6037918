"""HuBERT X-Large: encoder-only (bidirectional) [arXiv:2106.07447].

The port of `repro/configs/hubert_xlarge.py`, field for field.  48
layers, d_model 1280, 16 heads of 80 (MHA), GELU d_ff 5120, 504 cluster
targets padded to 2048: about 0.95 B parameters.  The conv waveform
frontend is a stub, as in the reference: the inputs are precomputed
frame embeddings (``embed_inputs=False``, `models.frontend`).  Its
attention is non-causal; encoder-only, so it has no decode shapes.
"""
from .base import ArchConfig, LayerSpec, Segment

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    segments=(Segment(48, (LayerSpec("attn", "mlp"),)),),
    activation="gelu",
    causal=False,
    encoder_only=True,
    embed_inputs=False,
    microbatches=4,
    attn_sharding="heads",
    notes="audio frontend stubbed: inputs are precomputed frame embeddings",
)
