"""qwen3-moe-235b-a22b [moe] 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, n_experts=128,
    top_k=8, d_expert=1536, head_dim=128, rope_theta=1_000_000.0)
