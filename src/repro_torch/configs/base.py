"""LM config dataclasses (the port of `repro/configs/base.py`).

`ArchConfig`, `LayerSpec`, `Segment`, `ShapeSpec` and `SparsityConfig`
keep the reference's fields and defaults, so a config reads the same on
both sides; ``dtype`` and ``cache_dtype`` give torch dtypes.  `reduce()`
derives the same tiny CPU smoke-test config as the reference's.

The port runs every forward of the reference's registry: attention,
Mamba and RWKV mixers; MLP, vector-sparse MLP (``use_sparse_ffn``), MoE
and RWKV channel-mix FFNs; token or embedding inputs (``embed_inputs``);
f32 or input-dtype matmul outputs (``bf16_flow``).  `supported_shapes`
applies the reference's skip rules to its four input shapes (`SHAPES`).
`param_count` and `active_param_count` are the reference's, counted from
the port's schema.  `SparsityConfig.targets` is read nowhere, in the
reference either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["LayerSpec", "Segment", "ShapeSpec", "SparsityConfig",
           "ArchConfig", "SHAPES", "uniform_segments"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"          # 'attn' | 'mamba' | 'rwkv_tm' | 'none'
    ffn: str = "mlp"             # 'mlp' | 'moe' | 'rwkv_cm' | 'none'
    window: int | None = None    # sliding-window size for local attention


@dataclasses.dataclass(frozen=True)
class Segment:
    repeat: int
    layers: tuple[LayerSpec, ...]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """The paper's technique as a config knob (weights pruned at vector
    granularity; activation vectors skipped at runtime)."""

    density: float = 0.235   # paper's VGG-16 operating point
    vk: int = 32             # vector (K-tile) length
    vn: int = 128            # output strip width
    targets: tuple[str, ...] = ("ffn", "attn_proj")  # which matmuls


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: tuple[Segment, ...]
    modality: str = "lm"              # serving dispatch; CNN configs say "cnn"
    moe: Any = None
    activation: str = "swiglu"
    head_dim_override: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    encoder_only: bool = False
    attn_free: bool = False
    subquadratic: bool = False        # eligible for long_500k
    embed_inputs: bool = True         # False => stub frontend (embeds input)
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    attn_sharding: str = "heads"      # 'heads' | 'sp' (read under a mesh)
    attn_impl: str = "xla"            # 'xla' | 'pallas': one kernel path here
    sparsity: SparsityConfig | None = SparsityConfig()
    param_dtype: str = "bfloat16"
    cache_dtype_str: str = "bfloat16"
    vocab_pad_to: int = 2048
    scan_chunk: int = 256
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    ce_chunk: int = 512
    z_loss: float = 1e-4
    remat: bool = True
    tp_hint: int = 16                 # model-axis width configs pad against
    optimizer: str = "adamw"          # 'adamw' | 'adafactor'
    microbatches: int = 1             # gradient-accumulation splits per step
    moe_dispatch: str = "gather_weights"  # | 'resident' (serve/decode)
    bf16_flow: bool = False           # bf16 matmul outputs (perf knob)
    grad_accum_dtype: str = "float32" # microbatch gradient accumulator
    flash_remat: bool = False         # recompute flash scores in backward
    use_sparse_ffn: bool = False      # vector-sparse FFN
    seq_shard_residual: bool = False  # Megatron-SP residual stream
    notes: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab // m) * m

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cache_dtype(self) -> torch.dtype:
        return getattr(torch, self.cache_dtype_str)

    @property
    def total_layers(self) -> int:
        return sum(s.repeat * len(s.layers) for s in self.segments)

    def supported_shapes(self) -> dict[str, str]:
        """shape name -> '' if runnable, else the skip reason."""
        out = {}
        for name, sh in SHAPES.items():
            reason = ""
            if sh.kind == "decode" and self.encoder_only:
                reason = "encoder-only: no autoregressive decode step"
            elif name == "long_500k" and not self.subquadratic:
                reason = ("pure full-attention arch: 524k context requires "
                          "sub-quadratic attention (assignment skip rule)")
            out[name] = reason
        return out

    def _param_shapes(self) -> list[tuple[str, tuple]]:
        """(path, shape) of every leaf of the LM schema, paths written as
        the reference's ``keystr``."""
        from repro_torch.models.layers import P
        from repro_torch.models.transformer import lm_schema
        out: list[tuple[str, tuple]] = []

        def walk(node: Any, path: str) -> None:
            if isinstance(node, P):
                out.append((path, node.shape))
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, f"{path}[{i}]")
            else:
                for k, v in node.items():
                    walk(v, f"{path}[{k!r}]")

        walk(lm_schema(self), "")
        return out

    def param_count(self) -> int:
        """Total parameters (embedding included), from the schema."""
        return sum(math.prod(s) for _, s in self._param_shapes())

    def active_param_count(self) -> int:
        """MoE-aware active parameters per token: a routed expert leaf
        counts top_k of its padded experts."""
        if self.moe is None:
            return self.param_count()
        ep = self.moe.padded_experts(self.tp_hint)
        total = 0
        for path, shape in self._param_shapes():
            n = math.prod(shape)
            if ("'ffn'" in path and "shared" not in path
                    and "router" not in path):
                n = n * self.moe.top_k // ep
            total += n
        return total

    def reduce(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests (the reference's)."""
        heads = max(2, min(4, self.n_heads))
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2), d_ff=64,
            )
        segs = tuple(
            Segment(repeat=min(s.repeat, 2),
                    layers=tuple(
                        dataclasses.replace(
                            sp, window=min(sp.window, 16) if sp.window else None
                        ) for sp in s.layers
                    ))
            for s in self.segments[:2]
        )
        return dataclasses.replace(
            self,
            d_model=64 * heads if self.attn_free else 32 * heads,
            n_heads=heads,
            n_kv_heads=kv,
            d_ff=128,
            vocab=512,
            vocab_pad_to=64,
            segments=segs,
            moe=moe,
            head_dim_override=None,
            scan_chunk=8,
            attn_block_q=32,
            attn_block_kv=32,
            ce_chunk=64,
            tp_hint=1,
            microbatches=1,
            param_dtype="float32",
            cache_dtype_str="float32",
        )


def uniform_segments(n_layers: int, spec: LayerSpec) -> tuple[Segment, ...]:
    """``n_layers`` repeats of one layer spec, as one segment."""
    return (Segment(repeat=n_layers, layers=(spec,)),)
