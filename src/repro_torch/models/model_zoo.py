"""Unified model API across the families (the port of
``repro.models.model_zoo``).

``build(cfg)`` returns a ``ModelAPI`` whose three entry points take a
``batch`` dict (and a cache for decode), hiding family differences from
the training loop and the serving loop:

  train:   batch = {tokens, labels}
  prefill: batch = {tokens}
  decode:  batch = {token (B,), pos (an int)} + cache

The port serves the ``dense`` and ``moe`` families; the four others
(``rwkv``, ``hybrid``, ``encdec``, ``vlm``) raise until they are ported
(ROADMAP.md, item G2).  ``input_specs`` produces :class:`ParamSpec`
records for every input of an (arch x shape) cell, allocating nothing.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from . import dense, moe
from .common import COMPUTE_DTYPE, count_params, init_from_specs, spec

# Fixed stub lengths for modality frontends at decode time (the
# reference's constant; used by the encdec family once it is ported).
ENCDEC_DECODE_SRC_LEN = 4096
FAMILIES = {"dense": dense, "moe": moe}
NOT_PORTED = ("encdec", "vlm", "rwkv", "hybrid")


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
    """The module of ``cfg.family`` (``dense`` or ``moe``)."""
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported to repro_torch yet "
            "(ROADMAP.md, item G2); the port serves 'dense' and 'moe'")
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    return FAMILIES[cfg.family]


def build(cfg: ModelConfig) -> ModelAPI:
    mod = family_module(cfg)
    specs = mod.param_specs(cfg)
    total = count_params(specs)
    return ModelAPI(
        cfg, specs,
        loss=lambda p, b: mod.loss_fn(p, b, cfg),
        prefill=lambda p, b: mod.prefill(p, b["tokens"], cfg),
        decode=lambda p, b, c: mod.decode_step(p, b["token"], b["pos"], c,
                                               cfg),
        cache_specs=lambda bs, sl: mod.cache_specs(cfg, bs, sl),
        num_params=total,
        num_active_params=(_moe_active_params(cfg, total)
                           if cfg.family == "moe" else total))


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
