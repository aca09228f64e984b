"""llama-3.2-vision-11b [vlm] cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Backbone only; the vision tower is a stub -- ``input_specs`` provides
precomputed patch embeddings already projected to d_model.  Every 5th layer
is a gated cross-attention layer (8 of 40), per the Llama-3.2-Vision layout.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256,
    cross_attn_period=5, n_img_tokens=1600, rope_theta=500_000.0)
