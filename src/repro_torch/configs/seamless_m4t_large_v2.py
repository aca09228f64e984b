"""seamless-m4t-large-v2 [audio] enc-dec backbone [arXiv:2308.11596; hf].

Assigned as the transformer BACKBONE only: the speech/text frontend is a
stub; ``input_specs`` provides precomputed frame embeddings for the encoder.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="seamless-m4t-large-v2", family="encdec", n_layers=24,
    n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=256206, rope_theta=10_000.0)
