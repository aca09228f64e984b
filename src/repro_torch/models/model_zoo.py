"""Unified model API across the six families (the port of
``repro.models.model_zoo``).

``build(cfg)`` returns a ``ModelAPI`` whose three entry points take a
``batch`` dict (and a cache/state for decode), hiding family differences
from the training loop and the serving loop:

  train:   batch = {tokens, labels [, src_embed | img_embed]}
  prefill: batch = {tokens [, src_embed | img_embed]}
  decode:  batch = {token (B,), pos (an int)} + cache/state

``input_specs`` produces :class:`ParamSpec` records for every input of an
(arch x shape) cell, allocating nothing.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from . import dense, encdec, moe, rwkv, ssm, vlm
from .common import COMPUTE_DTYPE, count_params, init_from_specs, spec

# Fixed stub lengths for modality frontends at decode time (the
# reference's constant).
ENCDEC_DECODE_SRC_LEN = 4096
FAMILIES = {"dense": dense, "moe": moe, "encdec": encdec, "vlm": vlm,
            "rwkv": rwkv, "hybrid": ssm}


class ModelAPI(NamedTuple):
    cfg: ModelConfig
    param_specs: Any
    loss: Callable          # (params, batch) -> scalar
    prefill: Callable       # (params, batch) -> (logits, cache)
    decode: Callable        # (params, batch, cache) -> (logits, cache)
    cache_specs: Callable   # (batch_size, seq_len) -> tree of ParamSpec
    num_params: int
    num_active_params: int  # = num_params for non-MoE


def _moe_active_params(cfg: ModelConfig, total: int) -> int:
    """Parameters touched per token: experts count only top_k of n_experts."""
    per_expert = 3 * cfg.d_model * cfg.d_expert
    all_experts = cfg.n_layers * cfg.n_experts * per_expert
    active_experts = cfg.n_layers * cfg.top_k * per_expert
    return total - all_experts + active_experts


def family_module(cfg: ModelConfig):
    """The module of ``cfg.family``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    return FAMILIES[cfg.family]


def build(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    mod = family_module(cfg)

    def prefill(p, b):
        if fam == "encdec":
            return mod.prefill(p, b["src_embed"], b["tokens"], cfg)
        if fam == "vlm":
            return mod.prefill(p, b["tokens"], b["img_embed"], cfg)
        return mod.prefill(p, b["tokens"], cfg)

    def cache_specs(bs, sl):
        if fam == "encdec":
            return mod.cache_specs(cfg, bs, sl, ENCDEC_DECODE_SRC_LEN)
        if fam == "rwkv":
            return mod.state_specs(cfg, bs)
        if fam == "hybrid":
            return mod.state_specs(cfg, bs, sl)
        return mod.cache_specs(cfg, bs, sl)

    specs = mod.param_specs(cfg)
    total = count_params(specs)
    return ModelAPI(
        cfg, specs,
        loss=lambda p, b: mod.loss_fn(p, b, cfg),
        prefill=prefill,
        decode=lambda p, b, c: mod.decode_step(p, b["token"], b["pos"], c,
                                               cfg),
        cache_specs=cache_specs,
        num_params=total,
        num_active_params=(_moe_active_params(cfg, total)
                           if fam == "moe" else total))


def init_params(api: ModelAPI, key: torch.Generator, device=None):
    """Random parameters drawn from ``key`` on ``device`` (default: the
    generator's device)."""
    return init_from_specs(api.param_specs, key, device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Tuple[dict, Optional[Any]]:
    """(batch specs, cache specs or None) for one (arch x shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    tok = spec(b, s, dtype=torch.int32)
    if shape.kind in ("train", "prefill"):
        batch = ({"tokens": tok, "labels": tok} if shape.kind == "train"
                 else {"tokens": tok})
        if cfg.family == "encdec":
            batch["src_embed"] = spec(b, s, cfg.d_model, dtype=COMPUTE_DTYPE)
        if cfg.family == "vlm":
            batch["img_embed"] = spec(b, cfg.n_img_tokens, cfg.d_model,
                                      dtype=COMPUTE_DTYPE)
        return batch, None
    # decode: one new token against a seq_len-deep cache/state
    batch = {"token": spec(b, dtype=torch.int32),
             "pos": spec(dtype=torch.int32)}
    return batch, build(cfg).cache_specs(b, s)
