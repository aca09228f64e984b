"""LM substrate: the six model families behind one ModelAPI (the port of
``repro.models``)."""
from . import attention, common, dense, encdec, model_zoo, moe, rwkv, ssm, vlm
from .model_zoo import ModelAPI, build, init_params, input_specs

__all__ = ["ModelAPI", "build", "init_params", "input_specs", "attention",
           "common", "dense", "encdec", "model_zoo", "moe", "rwkv", "ssm",
           "vlm"]
