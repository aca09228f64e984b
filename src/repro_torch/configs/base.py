"""Config system: model architectures and input shapes.

The port's own copy of the reference's ``repro.configs.base`` (the port
imports nothing of the reference package), field for field.  Every
assigned architecture is a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``reduced()`` yields a same-family shrunken
config for CPU smoke tests.  The four assigned input shapes are
``ShapeConfig`` entries.

Four fields are the reference's GSPMD sharding knobs:
``cast_params_before_scan``, ``gather_weights``, ``residual_sharding`` and
``attn_replicate``.  On a mesh they mean what they mean there (a bf16 cast
of the stacked layers, the per-layer weight gather, the residual's pinned
layout, q/k/v whole over "model"); on one device the last three are
identities and the first casts the layers to bf16 before the loop rather
than at each use.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                  # dense | moe | encdec | vlm | rwkv | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    shared_expert_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    # --- VLM ---
    cross_attn_period: int = 0   # every Nth layer is a cross-attention layer
    n_img_tokens: int = 0
    # --- SSM / RWKV ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # --- hybrid (zamba2-style shared attention) ---
    attn_period: int = 0         # shared attn block after every N ssm blocks
    # --- training-time knobs ---
    remat: bool = True
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    seq_chunk: int = 128         # rwkv/ssm chunk length
    # --- beyond-baseline performance knobs (EXPERIMENTS.md, Perf) ---
    cast_params_before_scan: bool = False  # bf16 FSDP all-gathers
    ce_chunked: int = 0          # >0: fused chunked CE, chunk length
    moe_dispatch: str = "cumsum"  # "cumsum" | "sort"
    bf16_reduce: bool = False    # row-parallel dots emit bf16 (Megatron-
                                 # style bf16 partial-sum all-reduce)
    gather_weights: bool = False  # pin FSDP to weight-gather (not psum)
    residual_sharding: str = "auto"  # auto | replicated | seq (Megatron-SP)
    bf16_grads: bool = False     # cast params bf16 for grad: bf16 grad sync
    attn_replicate: bool = False  # replicate q/k/v over 'model' in the
                                  # flash scan (for TP-misaligned heads)
    microbatch: int = 0          # >1: gradient-accumulation microbatches

    def optimized(self) -> "ModelConfig":
        """The beyond-paper optimized variant (see EXPERIMENTS.md Perf)."""
        # validated combination (EXPERIMENTS.md Perf): replicate attention
        # only where head counts are TP-misaligned; sequence-parallel
        # residuals are a separate, situational memory-vs-collective trade
        # (see the granite-8b iteration log).
        return dataclasses.replace(
            self, ce_chunked=512, moe_dispatch="sort", bf16_reduce=True,
            bf16_grads=True,
            attn_replicate=bool(self.n_kv_heads and self.n_kv_heads % 16))

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 for clean TP sharding."""
        return -(-self.vocab // 256) * 256

    def reduced(self) -> "ModelConfig":
        """Same-family tiny config for CPU smoke tests."""
        if self.attn_period:          # hybrid: 2 groups + 1 tail layer
            n_layers = min(self.n_layers, 2 * self.attn_period + 1)
        elif self.cross_attn_period:  # vlm: 2 groups of a shrunken period
            n_layers = 4
        else:
            n_layers = 2
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            cross_attn_period=2 if self.cross_attn_period else 0,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            d_expert=32 if self.d_expert else 0,
            shared_expert_ff=32 if self.shared_expert_ff else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_img_tokens=16 if self.n_img_tokens else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            attn_chunk_q=32,
            attn_chunk_kv=32,
            seq_chunk=16,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}

# Families with sub-quadratic decode state; everything else skips long_500k
# (see DESIGN.md Section 7).
LONG_CONTEXT_FAMILIES = ("rwkv", "hybrid")


def cell_is_runnable(model: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return model.family in LONG_CONTEXT_FAMILIES
    return True
