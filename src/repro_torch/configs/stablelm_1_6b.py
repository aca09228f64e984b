"""stablelm-1.6b [dense] full MHA [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=5632, vocab=100352, rope_theta=10_000.0)
