"""Encoder-decoder backbone (seamless-m4t-large-v2).

The port of ``repro.models.encdec``.  The backbone only: the speech
frontend is a stub, so the encoder consumes precomputed frame embeddings
(B, S_src, d) (``input_specs``, ``pipeline.frontend_stub``).  Decoder
layers carry self-attention (causal, cached at decode) and
cross-attention (keys/values from the encoder output, computed into a
cache at prefill; no rope).  At decode a layer's cross-attention reads
its own (B, S_src, KV, hd) slice of the stacked cache, every position of
it.  The reference's sharding hint stands where it puts it: the source
embeddings are constrained to the batch axes (``constrain``, the identity
on a plain tensor); the decoder's come through ``dense.embed`` and
``dense.lm_logits``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from ..parallel.constraints import BATCH, constrain, split_heads
from .attention import KVCache, attention, attn_param_specs, decode_attention
from .common import (COMPUTE_DTYPE, cast, dense, rms_norm,
                     softmax_cross_entropy, spec, swiglu)
from .dense import embed, lm_logits, run_layers, stack_caches


class EncDecCache(NamedTuple):
    self_kv: KVCache     # (L, B, S_max, KV, hd)
    cross_kv: KVCache    # (L, B, S_src, KV, hd)


def _mlp_specs(cfg: ModelConfig, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mlp_norm": spec(n, d), "w1": spec(n, d, f),
            "w3": spec(n, d, f), "w2": spec(n, f, d)}


def param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    enc = {
        "attn_norm": spec(ne, d),
        "attn": attn_param_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 prefix_shape=(ne,)),
        **_mlp_specs(cfg, ne),
    }
    dec = {
        "attn_norm": spec(nd, d),
        "attn": attn_param_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 prefix_shape=(nd,)),
        "cross_norm": spec(nd, d),
        "cross": attn_param_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                  prefix_shape=(nd,)),
        **_mlp_specs(cfg, nd),
    }
    return {
        "enc_in_norm": spec(d),
        "enc_layers": enc,
        "enc_out_norm": spec(d),
        "embed": spec(cfg.vocab_padded, d),
        "dec_layers": dec,
        "final_norm": spec(d),
        "lm_head": spec(d, cfg.vocab_padded),
    }


def encode(params, src_embed: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """src_embed: (B, S_src, d) stub frontend output -> encoder states."""
    x = constrain(cast(src_embed), BATCH, None, None)
    x = rms_norm(x, params["enc_in_norm"], cfg.norm_eps)

    def body(h, lp):
        a, _ = attention(
            rms_norm(h, lp["attn_norm"], cfg.norm_eps), lp["attn"],
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta, causal=False,
            chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
        h = h + a
        h = h + swiglu(rms_norm(h, lp["mlp_norm"], cfg.norm_eps),
                       lp["w1"], lp["w3"], lp["w2"])
        return h, None

    x, _ = run_layers(x, params["enc_layers"], cfg, body)
    return rms_norm(x, params["enc_out_norm"], cfg.norm_eps)


def _dec_layer(x, lp, cfg: ModelConfig, memory=None, self_cache=None,
               cross_cache=None, pos=None, return_cache=False):
    a, new_self = attention(
        rms_norm(x, lp["attn_norm"], cfg.norm_eps), lp["attn"],
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, causal=True, chunk_q=cfg.attn_chunk_q,
        chunk_kv=cfg.attn_chunk_kv, cache=self_cache, pos=pos,
        return_cache=return_cache)
    x = x + a
    h = rms_norm(x, lp["cross_norm"], cfg.norm_eps)
    if cross_cache is not None:          # decode: precomputed memory K/V
        b = h.shape[0]
        q = split_heads(dense(h, lp["cross"]["wq"]), cfg.n_heads)
        # this layer's (B, S_src, KV, hd) slice: every source position
        o = decode_attention(q, cross_cache, cross_cache.k.shape[1] - 1)
        x = x + dense(o.reshape(b, 1, -1), lp["cross"]["wo"])
        new_cross = cross_cache
    else:                                # train/prefill: full cross-attn
        o, new_cross = attention(
            h, lp["cross"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_theta=None, causal=False,
            chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
            memory=memory, return_cache=return_cache)
        x = x + o
    x = x + swiglu(rms_norm(x, lp["mlp_norm"], cfg.norm_eps),
                   lp["w1"], lp["w3"], lp["w2"])
    return x, new_self, new_cross


def decoder_forward(params, memory: torch.Tensor, tokens: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """The decoder over ``tokens`` against encoder states ``memory`` ->
    (B, S, V) logits."""
    x = embed(params, tokens)
    x, _ = run_layers(x, params["dec_layers"], cfg,
                      lambda h, lp: (_dec_layer(h, lp, cfg,
                                                memory=memory)[0], None))
    return lm_logits(params, x, cfg)


def forward(params, src_embed, tokens, cfg: ModelConfig) -> torch.Tensor:
    return decoder_forward(params, encode(params, src_embed, cfg), tokens,
                           cfg)


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    logits = forward(params, batch["src_embed"], batch["tokens"], cfg)
    return softmax_cross_entropy(logits, batch["labels"])


def prefill(params, src_embed, tokens, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, EncDecCache]:
    memory = encode(params, src_embed, cfg)
    x = embed(params, tokens)

    def body(h, lp):
        h, skv, ckv = _dec_layer(h, lp, cfg, memory=memory,
                                 return_cache=True)
        return h, (skv, ckv)

    x, kvs = run_layers(x, params["dec_layers"], cfg, body)
    return (lm_logits(params, x[:, -1:, :], cfg),
            EncDecCache(stack_caches([s for s, _ in kvs]),
                        stack_caches([c for _, c in kvs])))


def decode_step(params, token, pos, cache: EncDecCache, cfg: ModelConfig):
    """One decode step: the self caches are written in place at ``pos``;
    the cross caches are read."""
    x = embed(params, token[:, None])

    def body(h, layer):
        lp, self_kv, cross_kv = layer
        h, _, _ = _dec_layer(h, lp, cfg, self_cache=self_kv,
                             cross_cache=cross_kv, pos=pos)
        return h, None

    x, _ = run_layers(x, (params["dec_layers"], cache.self_kv,
                          cache.cross_kv), cfg, body, remat=False)
    return lm_logits(params, x, cfg), cache


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int, src_len: int
                ) -> EncDecCache:
    L = cfg.n_layers
    kv, hd = cfg.n_kv_heads, cfg.hd
    return EncDecCache(
        KVCache(spec(L, batch, seq_len, kv, hd, dtype=COMPUTE_DTYPE),
                spec(L, batch, seq_len, kv, hd, dtype=COMPUTE_DTYPE)),
        KVCache(spec(L, batch, src_len, kv, hd, dtype=COMPUTE_DTYPE),
                spec(L, batch, src_len, kv, hd, dtype=COMPUTE_DTYPE)))
