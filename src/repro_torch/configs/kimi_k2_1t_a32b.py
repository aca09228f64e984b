"""kimi-k2-1t-a32b [moe] trillion-param MoE, 384e top-8 [arXiv:2501.kimi2; unverified].

Per the assignment table: GQA kv=8 (not MLA), d_expert = 2048, plus one
shared expert of the same width (DeepSeek-V3 lineage).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840, n_experts=384,
    top_k=8, d_expert=2048, shared_expert_ff=2048, rope_theta=50_000.0)
