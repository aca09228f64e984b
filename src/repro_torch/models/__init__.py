"""LM substrate: the dense and MoE families behind one ModelAPI (the port
of ``repro.models``; the rwkv, hybrid, encdec and vlm families are
ROADMAP.md item G2)."""
from . import attention, common, dense, model_zoo, moe
from .model_zoo import ModelAPI, build, init_params, input_specs

__all__ = ["ModelAPI", "build", "init_params", "input_specs", "attention",
           "common", "dense", "model_zoo", "moe"]
