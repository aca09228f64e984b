"""Mixture-of-Experts decoder (kimi-k2, qwen3-moe).

The port of ``repro.models.moe``.  Token-choice top-k routing with
capacity-bounded expert buffers: each (token, choice) gets a position
inside its expert's buffer, by a cumulative sum over the (tokens,
experts) one-hot matrix (``moe_dispatch="cumsum"``) or by a stable sort
of the choices (``"sort"``), both in token order, so the two give the
same positions; overflow beyond capacity is dropped (weight 0).  Experts
are stacked (L, E, ...).

Ties: ``jax.lax.top_k`` puts the lower expert first among equal
probabilities; ``torch.topk`` makes no such promise, so the choices come
from a stable descending sort.

The reference's sharding hints come through ``dense.attend`` (the weight
gather point under ``gather_weights``, ``constrain_residual`` before the
attention, q/k/v replicated under ``attn_replicate``) and
``dense.maybe_cast_stack`` in ``loss_fn``.  On a mesh each rank
multiplies its experts' slices of the buffers (``expert_product``,
experts over "model", buffer slots over the data axes), while the buffer
positions, the scatter into the buffers and the gather back run on every
rank over the whole token table (``constraints.local_map``: DTensor has
no strategy for ``searchsorted`` or for these index writes and gathers);
on one device they are the same operations on plain tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..parallel.constraints import expert_product, is_dtensor, local_map, \
    rows
from .attention import KVCache, attn_param_specs
from .common import COMPUTE_DTYPE, cast, dense, matmul_f32, rms_norm, spec, \
    swiglu, unstack
from .dense import (attend, cache_specs, embed, init_cache, lm_logits,
                    lm_loss, maybe_cast_stack, run_layers, stack_caches)

__all__ = ["layer_param_specs", "param_specs", "moe_ffn", "forward",
           "loss_fn", "cache_specs", "init_cache", "prefill", "decode_step"]


def layer_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    p = {
        "attn_norm": spec(n_layers, d),
        "attn": attn_param_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 cfg.qkv_bias, prefix_shape=(n_layers,)),
        "mlp_norm": spec(n_layers, d),
        "router": spec(n_layers, d, e),
        "exp_w1": spec(n_layers, e, d, fe),
        "exp_w3": spec(n_layers, e, d, fe),
        "exp_w2": spec(n_layers, e, fe, d),
    }
    if cfg.shared_expert_ff:
        fs = cfg.shared_expert_ff
        p["shared_w1"] = spec(n_layers, d, fs)
        p["shared_w3"] = spec(n_layers, d, fs)
        p["shared_w2"] = spec(n_layers, fs, d)
    return p


def param_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": spec(cfg.vocab_padded, cfg.d_model),
        "layers": layer_param_specs(cfg, cfg.n_layers),
        "final_norm": spec(cfg.d_model),
        "lm_head": spec(cfg.d_model, cfg.vocab_padded),
    }


def _capacity(num_tokens: int, cfg: ModelConfig) -> int:
    cap = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)           # multiple of 8, at least 8


def _buffer_positions(choice: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(T, k) position of each (token, choice) in its expert's buffer: its
    rank among the earlier (token, choice) pairs of the same expert.  On a
    mesh every rank ranks all the choices (``local_map`` over the whole
    table: DTensor has no strategy for ``searchsorted``)."""
    if is_dtensor(choice):
        return local_map(lambda c: _buffer_positions(c, cfg), (choice,),
                         [None], [None])
    t, k = choice.shape
    if cfg.moe_dispatch == "sort":
        flat_choice = choice.reshape(-1)
        order = torch.argsort(flat_choice, stable=True)
        sorted_c = flat_choice[order]
        start = torch.searchsorted(sorted_c, sorted_c, right=False)
        rank_sorted = torch.arange(t * k, device=choice.device) - start
        pos = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
        return pos.reshape(t, k)
    onehot = F.one_hot(choice, cfg.n_experts)                  # (T, k, E)
    flat = onehot.reshape(t * k, cfg.n_experts)
    pos_flat = torch.cumsum(flat, dim=0) * flat                # 1-based
    return pos_flat.reshape(t, k, cfg.n_experts).sum(-1) - 1


def moe_ffn(x: torch.Tensor, lp: dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). Capacity-bounded top-k dispatch."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(t, cfg)
    xt = rows(x).reshape(t, d)            # rows: a plain batch split

    logits = dense(xt, lp["router"]).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, choice = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    gate_vals, choice = gate_vals[:, :k], choice[:, :k]        # (T, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    pos = _buffer_positions(choice, cfg)
    keep = (pos >= 0) & (pos < cap)
    pos_c = torch.clamp(pos, 0, cap - 1)

    # Scatter tokens into (E, cap, d) buffers: kept slots are distinct, a
    # dropped token adds 0 into the last slot.
    slot = (choice * cap + pos_c).reshape(-1)

    def dispatch(xt, slot, keep):
        src = torch.where(keep.reshape(-1, 1),
                          cast(xt).repeat_interleave(k, 0), 0)
        buf = torch.zeros(e * cap, d, dtype=COMPUTE_DTYPE, device=xt.device)
        return buf.index_put((slot,), src, accumulate=True).reshape(e, cap,
                                                                     d)

    def combine(out_buf, slot, keep, gate_vals):
        gathered = out_buf.reshape(e * cap, d)[slot].reshape(t, k, d)
        w = torch.where(keep, gate_vals, 0.0).float()
        return (gathered.float() * w[..., None]).sum(1)

    # on a mesh both run on the whole token table and buffer (DTensor has
    # no strategy for these index writes and gathers)
    whole = [None] * 4
    buf = local_map(dispatch, (xt, slot, keep), whole[:3], [None])

    # on a mesh each rank multiplies its experts' slices of the buffers
    h = expert_product(matmul_f32, buf, lp["exp_w1"])
    h3 = expert_product(matmul_f32, buf, lp["exp_w3"])
    h = (F.silu(h) * h3).to(COMPUTE_DTYPE)
    out_buf = expert_product(
        (lambda a, w: torch.matmul(a, cast(w))) if cfg.bf16_reduce
        else (lambda a, w: matmul_f32(a, w).to(COMPUTE_DTYPE)), h,
        lp["exp_w2"])

    # Gather back and combine with gate weights.
    out = local_map(combine, (out_buf, slot, keep, gate_vals), whole,
                    [None])

    # Switch-style load-balance aux loss over all k choices.
    me = probs.mean(0)                                         # (E,)
    ce = F.one_hot(choice, e).float().mean((0, 1))
    aux = e * torch.sum(me * ce)

    if cfg.shared_expert_ff:
        out = out + swiglu(xt, lp["shared_w1"], lp["shared_w3"],
                           lp["shared_w2"]).float()
    return rows(out.reshape(b, s, d).to(COMPUTE_DTYPE)), aux


def _layer(x, lp, cfg: ModelConfig, *, cache=None, pos=None,
           return_cache=False):
    x, new_cache = attend(x, lp, cfg, cache=cache, pos=pos,
                          return_cache=return_cache)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    m, aux = moe_ffn(h, lp, cfg)
    return x + m, new_cache, aux


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = embed(params, tokens)

    def body(h, lp):
        h, _, aux = _layer(h, lp, cfg)
        return h, aux

    x, auxs = run_layers(x, params["layers"], cfg, body)
    return lm_logits(params, x, cfg), torch.stack(auxs).mean()


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    x = embed(params, batch["tokens"])

    def body(h, lp):
        h, _, aux = _layer(h, lp, cfg)
        return h, aux

    x, auxs = run_layers(x, maybe_cast_stack(params["layers"], cfg), cfg,
                         body)
    return (lm_loss(params, x, batch["labels"], cfg)
            + cfg.router_aux_weight * torch.stack(auxs).mean())


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    x = embed(params, tokens)

    def body(h, lp):
        h, kv, _ = _layer(h, lp, cfg, return_cache=True)
        return h, kv

    x, caches = run_layers(x, params["layers"], cfg, body)
    return lm_logits(params, x[:, -1:, :], cfg), stack_caches(caches)


def decode_step(params: dict, token: torch.Tensor, pos, cache: KVCache,
                cfg: ModelConfig):
    """One decode step; the stacked cache is written in place at ``pos``."""
    x = embed(params, token[:, None])
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        x, _, _ = _layer(x, lp, cfg, cache=KVCache(cache.k[i], cache.v[i]),
                         pos=pos)
    return lm_logits(params, x, cfg), cache
