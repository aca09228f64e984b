"""zamba2-7b [hybrid] Mamba2 backbone + shared attention blocks [arXiv:2411.15242; unverified].

81 Mamba2 blocks; one weight-shared attention(+MLP) block applied after every
6th Mamba2 block (13 applications), d_state = 64.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000, ssm_state=64,
    ssm_head_dim=64, attn_period=6)
