"""Dense decoder-only LM (llama lineage: granite, stablelm, qwen2.5).

The port of ``repro.models.dense``.  Layers are stacked along a leading
``L`` axis, as the reference's; its ``lax.scan`` over them is a Python
loop over the ``L`` slices, each layer checkpointed
(``torch.utils.checkpoint``, non-reentrant) when ``cfg.remat``.

The reference's sharding hints stand where it puts them: ``constrain`` at
the embedding output and the logits, ``constrain_residual`` at block
boundaries (``residual_sharding``), ``constrain_compute`` under
``gather_weights`` and ``maybe_cast_stack`` under
``cast_params_before_scan``.  On a mesh they redistribute DTensors; on
plain tensors they are identities, as is the one point DTensor needs where
the reference needs none: ``embed`` gathers the vocab-sharded table whole
on ``"model"`` before the lookup (DTensor's masked embedding cannot take a
data-sharded token batch), and ``_ce_chunk`` does the same for a chunk's
logits before the cross entropy (``common.softmax_cross_entropy``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..parallel.constraints import BATCH, MODEL, constrain, replicate
from .attention import KVCache, attention, attn_param_specs
from .common import (COMPUTE_DTYPE, cast, ce_terms, dense, matmul_f32,
                     rms_norm, softmax_cross_entropy, spec, swiglu,
                     tree_leaves, tree_map, unstack)


def layer_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "attn_norm": spec(n_layers, d),
        "attn": attn_param_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 cfg.qkv_bias, prefix_shape=(n_layers,)),
        "mlp_norm": spec(n_layers, d),
        "w1": spec(n_layers, d, f),
        "w3": spec(n_layers, d, f),
        "w2": spec(n_layers, f, d),
    }


def param_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": spec(cfg.vocab_padded, cfg.d_model),
        "layers": layer_param_specs(cfg, cfg.n_layers),
        "final_norm": spec(cfg.d_model),
        "lm_head": spec(cfg.d_model, cfg.vocab_padded),
    }


def constrain_residual(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pin the residual stream's sharding at block boundaries.

    'replicated': (batch, None, None) -- the canonical Megatron layout.
    'seq': (batch, model, None) -- Megatron sequence parallelism."""
    if cfg.residual_sharding == "replicated" and x.ndim == 3:
        return constrain(x, BATCH, None, None)
    if cfg.residual_sharding == "seq" and x.ndim == 3:
        return constrain(x, BATCH, MODEL, None)
    return x


def attend(x: torch.Tensor, lp: dict, cfg: ModelConfig, *,
           causal: bool = True, cache: Optional[KVCache] = None, pos=None,
           return_cache: bool = False):
    """The attention half of a layer: the weight gather point, pre-norm,
    attention and residual (shared with the MoE family)."""
    if cfg.gather_weights:
        from ..parallel.rules import constrain_compute
        lp = constrain_compute(lp)
    x = constrain_residual(x, cfg)
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    if cfg.residual_sharding == "seq":
        h = constrain(h, BATCH, None, None)   # gather S for attention
    a, new_cache = attention(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta, causal=causal,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
        cache=cache, pos=pos, return_cache=return_cache,
        bf16_wire=cfg.bf16_reduce, replicate_heads=cfg.attn_replicate)
    return x + a, new_cache


def _layer(x: torch.Tensor, lp: dict, cfg: ModelConfig, *,
           causal: bool = True, cache: Optional[KVCache] = None, pos=None,
           return_cache: bool = False
           ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    x, new_cache = attend(x, lp, cfg, causal=causal, cache=cache, pos=pos,
                          return_cache=return_cache)
    x = constrain_residual(x, cfg)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    x = x + swiglu(h, lp["w1"], lp["w3"], lp["w2"],
                   bf16_wire=cfg.bf16_reduce)
    return x, new_cache


def run_layers(x: torch.Tensor, layers, cfg: ModelConfig, layer_fn,
               remat: bool = None):
    """``layer_fn(h, lp) -> (h, y)`` over the stacked layers (the
    reference's ``lax.scan``: ``layers`` is any tree whose leaves share the
    leading axis, e.g. ``(params, state)``), each layer checkpointed when
    ``remat`` (default ``cfg.remat``) and autograd records; returns the
    last ``h`` and the list of ``y``."""
    ys = []
    remat = (cfg.remat if remat is None else remat) and \
        torch.is_grad_enabled()
    n = tree_leaves(layers)[0].shape[0]
    for lp in unstack(layers, n):
        if remat:
            x, y = checkpoint(layer_fn, x, lp, use_reentrant=False)
        else:
            x, y = layer_fn(x, lp)
        ys.append(y)
    return x, ys


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding: its backward on the card sums repeated tokens in a
    # fixed order (a restart repeats a step's bits).  On a mesh the table
    # is gathered whole on "model" first (identity on a plain tensor).
    table = replicate(params["embed"], ("model",))
    return constrain(cast(F.embedding(tokens.long(), table)), BATCH, None,
                     None)


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    x = constrain(x, BATCH, None, None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return constrain(dense(x, params["lm_head"]), BATCH, None, MODEL)


def _ce_chunk(xb: torch.Tensor, lb: torch.Tensor, head: torch.Tensor
              ) -> torch.Tensor:
    logits = constrain(matmul_f32(xb, head), BATCH, None, MODEL)
    lse, ll = ce_terms(logits, lb)
    return torch.sum(lse - ll)


def lm_loss(params: dict, x: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Final-norm + head + CE.

    With ``cfg.ce_chunked`` > 0 the (B, S, V) logits tensor is never
    materialized: sequence chunks are projected, reduced to (lse,
    label-logit) sums and recomputed in the backward pass (one checkpoint a
    chunk, the reference's ``jax.checkpoint`` scan body).
    """
    if not cfg.ce_chunked:
        return softmax_cross_entropy(lm_logits(params, x, cfg), labels)
    x = constrain(x, BATCH, None, None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    b, s, _ = x.shape
    chunk = math.gcd(cfg.ce_chunked, s)
    head = cast(params["lm_head"])
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        xb, lb = x[:, i:i + chunk], labels[:, i:i + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_ce_chunk, xb, lb, head, use_reentrant=False)
        else:
            part = _ce_chunk(xb, lb, head)
        total = total + part
    return total / (b * s)


def maybe_cast_stack(tree, cfg: ModelConfig):
    """bf16-cast stacked layer params before the layer loop, so FSDP
    gathers move bf16, not float32 (``cast_params_before_scan``)."""
    if not cfg.cast_params_before_scan:
        return tree
    return tree_map(lambda p: cast(p) if p.dtype == torch.float32
                    and p.dim() >= 2 else p, tree)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """Full-sequence causal forward -> (B, S, V) logits (train path)."""
    x = embed(params, tokens)
    x, _ = run_layers(x, params["layers"], cfg,
                      lambda h, lp: (_layer(h, lp, cfg)[0], None))
    return lm_logits(params, x, cfg)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    x = embed(params, batch["tokens"])
    x, _ = run_layers(x, maybe_cast_stack(params["layers"], cfg), cfg,
                      lambda h, lp: (_layer(h, lp, cfg)[0], None))
    return lm_loss(params, x, batch["labels"], cfg)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> KVCache:
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(spec(*shape, dtype=COMPUTE_DTYPE),
                   spec(*shape, dtype=COMPUTE_DTYPE))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None) -> KVCache:
    s = cache_specs(cfg, batch, seq_len)
    return KVCache(torch.zeros(s.k.shape, dtype=s.k.dtype, device=device),
                   torch.zeros(s.v.shape, dtype=s.v.dtype, device=device))


def stack_caches(caches: list) -> KVCache:
    """Per-layer caches -> one stacked (L, B, S, KV, hd) cache."""
    return KVCache(torch.stack([c.k for c in caches]),
                   torch.stack([c.v for c in caches]))


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt; returns last-position logits + stacked KV caches."""
    x = embed(params, tokens)
    x, caches = run_layers(
        x, params["layers"], cfg,
        lambda h, lp: _layer(h, lp, cfg, return_cache=True))
    return lm_logits(params, x[:, -1:, :], cfg), stack_caches(caches)


def decode_step(params: dict, token: torch.Tensor, pos, cache: KVCache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """One decode step.  token: (B,) int; pos: an int (or a 0-d tensor);
    cache: stacked (L, B, S_max, KV, hd), written in place at ``pos`` and
    returned."""
    x = embed(params, token[:, None])
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        x, _ = _layer(x, lp, cfg, cache=KVCache(cache.k[i], cache.v[i]),
                      pos=pos)
    return lm_logits(params, x, cfg), cache
