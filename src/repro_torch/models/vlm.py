"""VLM backbone (llama-3.2-vision-11b): decoder with gated cross-attention.

The port of ``repro.models.vlm``.  Backbone only: the vision tower is a
stub; ``input_specs`` provides precomputed patch embeddings (B,
n_img_tokens, d_model).  Layout follows Llama-3.2-Vision: every
``cross_attn_period``-th layer is a gated cross-attention(+MLP) layer --
with period 5 over 40 layers the stack is 8 groups of (4 self layers + 1
cross layer).  The self layers are stacked (G, P-1, ...) and run as a
loop inside the loop over groups (the reference's scan inside a scan),
a group checkpointed under ``remat``.  The embedding and the head are
sized by ``vocab``, not ``vocab_padded``, as the reference's.  At decode a
group's cross-attention reads its own (B, n_img, KV, hd) slice of the
stacked cache, every position of it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from ..parallel.constraints import split_heads
from .attention import KVCache, attention, attn_param_specs, decode_attention
from .common import (COMPUTE_DTYPE, cast, dense, rms_norm,
                     softmax_cross_entropy, spec, swiglu, tree_map)
from .dense import _layer as self_layer
from .dense import embed, layer_param_specs, lm_logits, run_layers


class VLMCache(NamedTuple):
    self_kv: KVCache     # (G, P-1, B, S_max, KV, hd)
    cross_kv: KVCache    # (G, B, n_img, KV, hd)


def _shape(cfg: ModelConfig) -> Tuple[int, int]:
    period = cfg.cross_attn_period
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers do not tile into groups "
                         f"of {period}")
    return cfg.n_layers // period, period


def param_specs(cfg: ModelConfig) -> dict:
    groups, period = _shape(cfg)
    d = cfg.d_model
    cross = {
        "norm": spec(groups, d),
        "attn": attn_param_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 prefix_shape=(groups,)),
        "gate_attn": spec(groups),
        "mlp_norm": spec(groups, d),
        "w1": spec(groups, d, cfg.d_ff),
        "w3": spec(groups, d, cfg.d_ff),
        "w2": spec(groups, cfg.d_ff, d),
        "gate_mlp": spec(groups),
    }
    self_specs = tree_map(lambda s: spec(groups, *s.shape, dtype=s.dtype),
                          layer_param_specs(cfg, period - 1))
    return {
        "embed": spec(cfg.vocab, d),
        "self_layers": self_specs,
        "cross_layers": cross,
        "img_norm": spec(d),
        "final_norm": spec(d),
        "lm_head": spec(d, cfg.vocab),
    }


def _cross_layer(x, cp, cfg: ModelConfig, img=None, cross_cache=None,
                 return_cache=False):
    h = rms_norm(x, cp["norm"], cfg.norm_eps)
    if cross_cache is not None:
        b = h.shape[0]
        q = split_heads(dense(h, cp["attn"]["wq"]), cfg.n_heads)
        # this group's (B, n_img, KV, hd) slice: every image position
        o = decode_attention(q, cross_cache, cross_cache.k.shape[1] - 1)
        a = dense(o.reshape(b, 1, -1), cp["attn"]["wo"])
        new_cache = cross_cache
    else:
        a, new_cache = attention(
            h, cp["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_theta=None, causal=False,
            chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
            memory=img, return_cache=return_cache)
    x = x + torch.tanh(cp["gate_attn"]).to(COMPUTE_DTYPE) * a
    m = swiglu(rms_norm(x, cp["mlp_norm"], cfg.norm_eps),
               cp["w1"], cp["w3"], cp["w2"])
    x = x + torch.tanh(cp["gate_mlp"]).to(COMPUTE_DTYPE) * m
    return x, new_cache


def _image(params, img_embed, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(cast(img_embed), params["img_norm"], cfg.norm_eps)


def forward(params, tokens, img_embed, cfg: ModelConfig) -> torch.Tensor:
    x = embed(params, tokens)
    img = _image(params, img_embed, cfg)

    def group(h, gp):
        sp, cp = gp
        h, _ = run_layers(h, sp, cfg,
                          lambda hh, lp: (self_layer(hh, lp, cfg)[0], None),
                          remat=False)
        h, _ = _cross_layer(h, cp, cfg, img=img)
        return h, None

    x, _ = run_layers(x, (params["self_layers"], params["cross_layers"]),
                      cfg, group)
    return lm_logits(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    logits = forward(params, batch["tokens"], batch["img_embed"], cfg)
    return softmax_cross_entropy(logits, batch["labels"])


def prefill(params, tokens, img_embed, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, VLMCache]:
    x = embed(params, tokens)
    img = _image(params, img_embed, cfg)

    def group(h, gp):
        sp, cp = gp
        h, self_kv = run_layers(
            h, sp, cfg,
            lambda hh, lp: self_layer(hh, lp, cfg, return_cache=True),
            remat=False)
        h, cross_kv = _cross_layer(h, cp, cfg, img=img, return_cache=True)
        return h, (KVCache(torch.stack([c.k for c in self_kv]),
                           torch.stack([c.v for c in self_kv])), cross_kv)

    x, kvs = run_layers(x, (params["self_layers"], params["cross_layers"]),
                        cfg, group)
    skv = KVCache(torch.stack([s.k for s, _ in kvs]),
                  torch.stack([s.v for s, _ in kvs]))
    ckv = KVCache(torch.stack([c.k for _, c in kvs]),
                  torch.stack([c.v for _, c in kvs]))
    return lm_logits(params, x[:, -1:, :], cfg), VLMCache(skv, ckv)


def decode_step(params, token, pos, cache: VLMCache, cfg: ModelConfig):
    """One decode step: the self caches are written in place at ``pos``;
    the cross caches are read."""
    x = embed(params, token[:, None])

    def layer(h, lp_kv):
        lp, kv = lp_kv
        return self_layer(h, lp, cfg, cache=kv, pos=pos)[0], None

    def group(h, g):
        sp, cp, self_kv, cross_kv = g
        h, _ = run_layers(h, (sp, self_kv), cfg, layer, remat=False)
        h, _ = _cross_layer(h, cp, cfg, cross_cache=cross_kv)
        return h, None

    x, _ = run_layers(x, (params["self_layers"], params["cross_layers"],
                          cache.self_kv, cache.cross_kv), cfg, group,
                      remat=False)
    return lm_logits(params, x, cfg), cache


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> VLMCache:
    groups, period = _shape(cfg)
    kv, hd = cfg.n_kv_heads, cfg.hd
    self_kv = spec(groups, period - 1, batch, seq_len, kv, hd,
                   dtype=COMPUTE_DTYPE)
    cross_kv = spec(groups, batch, cfg.n_img_tokens, kv, hd,
                    dtype=COMPUTE_DTYPE)
    return VLMCache(KVCache(self_kv, self_kv), KVCache(cross_kv, cross_kv))
