"""rwkv6-1.6b [ssm] Finch: attention-free, data-dependent decay [arXiv:2404.05892; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="rwkv6-1.6b", family="rwkv", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=0, d_ff=7168, vocab=65536, ssm_head_dim=64,
    ssm_state=64, seq_chunk=32)
