"""Architecture registry: the 10 assigned architectures + paper configs
(``spinner_paper``), copied from the reference's ``repro.configs``."""
from . import (granite_8b, granite_20b, kimi_k2_1t_a32b,
               llama_3_2_vision_11b, qwen2_5_14b, qwen3_moe_235b_a22b,
               rwkv6_1_6b, seamless_m4t_large_v2, stablelm_1_6b, zamba2_7b)
from .base import (LONG_CONTEXT_FAMILIES, SHAPES, SHAPES_BY_NAME, ModelConfig,
                   ShapeConfig, cell_is_runnable)

ARCHS = {
    m.CONFIG.arch: m.CONFIG
    for m in (granite_8b, granite_20b, stablelm_1_6b, qwen2_5_14b,
              seamless_m4t_large_v2, kimi_k2_1t_a32b, qwen3_moe_235b_a22b,
              llama_3_2_vision_11b, rwkv6_1_6b, zamba2_7b)
}

__all__ = ["ARCHS", "ModelConfig", "ShapeConfig", "SHAPES", "SHAPES_BY_NAME",
           "LONG_CONTEXT_FAMILIES", "cell_is_runnable"]
