"""Mamba2 (SSD) blocks and the Zamba2 hybrid stack.

The port of ``repro.models.ssm``.  Mamba2's scalar-per-head decay makes
the chunked scan two products a chunk: (C @ B^T) scaled elementwise by a
(chunk, chunk) decay matrix per head, and the carried state is (H, N, hd)
per sequence.  Chunks run in order in a Python loop (the reference's
``lax.scan``), each chunk step checkpointed when autograd records, as the
reference's ``jax.checkpoint(step)``.

Zamba2 (arXiv:2411.15242): 81 Mamba2 blocks with ONE weight-shared
attention(+MLP) block applied after every 6th Mamba2 block (13
applications) plus a 3-block tail.  The shared block's tensors are the
same leaves at every application, so autograd sums their gradients over
all of them, under ``remat`` too.  As the reference, a group (its Mamba2
blocks and the shared block) is checkpointed only in training.
Simplifications of the reference against the checkpoint, kept: the
shared block consumes the current hidden state (no concat-with-embedding
projection), the conv is applied to x only (not B/C).

``dt`` is ``softplus`` in ``jax.nn.softplus``'s form, ``logaddexp(x,
0)``.  Neither form gives the reference's bits (XLA's CPU ``exp`` differs
from torch's in the last bit for ~10% of float32 inputs): on 200,000
draws of N(0, 10^2), ``torch.logaddexp`` differs in 3.3% of them,
``torch.nn.functional.softplus`` (``x`` above its threshold of 20,
``log1p(exp(x))`` below) in 6.2%, each by at most 3 ulp.  The conv
(:func:`_causal_conv`) equals the reference's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..parallel.constraints import is_dtensor, local_map, split_heads
from .attention import KVCache, attention, attn_param_specs
from .common import (COMPUTE_DTYPE, dense, rms_norm, softmax_cross_entropy,
                     spec, swiglu, tree_map)
from .dense import embed, lm_logits, run_layers


class MambaState(NamedTuple):
    conv: torch.Tensor   # (..., B, W-1, d_in)   conv tail carry
    s: torch.Tensor      # (..., B, H, N, hd)    SSD state, float32


class ZambaState(NamedTuple):
    mamba: MambaState          # leading dims (n_groups, period)
    tail: MambaState           # leading dim (max(tail, 1),)
    attn: KVCache              # (n_groups, B, S_max, KV, hd)
    pos: torch.Tensor          # () int32 (tokens written)


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    return d_in, h, cfg.ssm_state


def mamba_param_specs(cfg: ModelConfig, prefix_shape: Tuple[int, ...]) -> dict:
    d = cfg.d_model
    d_in, h, n = _dims(cfg)
    ps = prefix_shape
    return {
        "norm": spec(*ps, d),
        "wz": spec(*ps, d, d_in),
        "wx": spec(*ps, d, d_in),
        "wB": spec(*ps, d, n),
        "wC": spec(*ps, d, n),
        "wdt": spec(*ps, d, h),
        "conv_w": spec(*ps, cfg.conv_width, d_in),
        "conv_bias": spec(*ps, d_in),
        "A_log": spec(*ps, h),
        "skip_D": spec(*ps, h),
        "dt_bias": spec(*ps, h),
        "gn_scale": spec(*ps, d_in),
        "out_proj": spec(*ps, d_in, d),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 carry: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, width W; x: (B, S, C), w: (W, C).

    ``carry`` is the previous W-1 inputs (B, W-1, C); returns new carry.
    The W taps are summed in float32 in the order j = 0..W-1.
    """
    bsz, s, c = x.shape
    wdt = w.shape[0]
    if carry is None:
        carry = torch.zeros(bsz, wdt - 1, c, dtype=x.dtype, device=x.device)
    ext = torch.cat([carry, x], dim=1)                 # (B, S+W-1, C)
    out = torch.zeros(bsz, s, c, dtype=torch.float32, device=x.device)
    for j in range(wdt):
        out = out + ext[:, j:j + s, :].float() * w[j].float()
    out = out + bias.float()
    new_carry = ext[:, -(wdt - 1):, :] if wdt > 1 else carry
    return F.silu(out).to(COMPUTE_DTYPE), new_carry


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssd_step(S, xb, bb, cb, db, lb):
    """One chunk: the carried state S (B, H, N, hd) and the chunk's x
    (B, C, H, hd), B/C (B, C, N), dt and log decay (B, C, H) -> (S_new,
    out (B, C, H, hd) bf16)."""
    xb, bb, cb, db, lb = (x.float() for x in (xb, bb, cb, db, lb))
    c = xb.shape[1]
    lai = torch.cumsum(lb, dim=1)                      # (B,C,H) inclusive
    # intra: P[t,s,h] = (C_t . B_s) exp(lai_t - lai_s) dt_s, s <= t
    cb_ = torch.einsum("btn,bsn->bts", cb, bb)         # (B,C,C)
    dm = lai[:, :, None, :] - lai[:, None, :, :]       # (B,C,C,H)
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=S.device))
    dm = torch.where(tri[None, :, :, None], dm, -torch.inf)
    P = cb_[..., None] * torch.exp(dm) * db[:, None, :, :]
    intra = torch.einsum("btsh,bshd->bthd", P, xb)
    inter = (torch.einsum("btn,bhnd->bthd", cb, S)
             * torch.exp(lai)[..., None])
    out = intra + inter
    tail = lai[:, -1:, :]                              # (B,1,H)
    S_new = (torch.exp(tail[:, 0])[:, :, None, None] * S
             + torch.einsum("bsn,bshd->bhnd", bb,
                            (db * torch.exp(tail - lai))[..., None] * xb))
    return S_new, out.to(COMPUTE_DTYPE)


def ssd_chunked(xh, Bc, Cc, dt, a_log, s0, chunk: int):
    """Chunked SSD scan.

    xh: (B, S, H, hd); Bc/Cc: (B, S, N); dt: (B, S, H) (post-softplus);
    a_log: (H,) (negative); s0: (B, H, N, hd).
    Recurrence: S_t = exp(dt_t a_log) S_{t-1} + dt_t B_t (x) xh_t;
                y_t = C_t . S_t.
    ``S`` must be a multiple of ``min(chunk, S)``, as the reference asserts.
    On a mesh each rank scans its own batch rows and heads (``local_map``).
    """
    if is_dtensor(xh):
        return local_map(lambda *a: ssd_chunked(*a, chunk),
                         (xh, Bc, Cc, dt, a_log, s0),
                         [(0, 2), (0, None), (0, None), (0, 2), (None, 0),
                          (0, 1)], [(0, 2), (0, 1)], heads=xh.shape[2])
    b, s, h, hd = xh.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc = s // chunk
    la_step = dt * a_log[None, None, :]                # (B,S,H) <= 0

    def chunks(x):
        return torch.unbind(x.reshape(b, nc, chunk, *x.shape[2:]), 1)

    S = s0.float()
    remat = torch.is_grad_enabled()
    outs = []
    for xs in zip(*map(chunks, (xh, Bc, Cc, dt, la_step))):
        if remat:
            S, out = checkpoint(_ssd_step, S, *xs, use_reentrant=False)
        else:
            S, out = _ssd_step(S, *xs)
        outs.append(out)
    return torch.stack(outs, 1).reshape(b, s, h, hd), S


def ssd_ref(xh, Bc, Cc, dt, a_log, s0):
    """Step-by-step oracle."""
    S = s0.float()
    outs = []
    for t in range(xh.shape[1]):
        xt, bt, ct, dtt = (x[:, t].float() for x in (xh, Bc, Cc, dt))
        decay = torch.exp(dtt * a_log.float())          # (B,H)
        S = decay[:, :, None, None] * S + torch.einsum(
            "bn,bhd->bhnd", bt, dtt[..., None] * xt)
        outs.append(torch.einsum("bn,bhnd->bhd", ct, S))
    return torch.stack(outs, 1).to(COMPUTE_DTYPE), S


def mamba_block(x, lp, cfg: ModelConfig, state: MambaState
                ) -> Tuple[torch.Tensor, MambaState]:
    """x: (B, S, d) -> (out, new_state)."""
    b, s, d = x.shape
    d_in, h, n = _dims(cfg)
    hd = cfg.ssm_head_dim
    hx = rms_norm(x, lp["norm"], cfg.norm_eps)

    z = dense(hx, lp["wz"])
    xin = dense(hx, lp["wx"])
    Bc = dense(hx, lp["wB"]).float()
    Cc = dense(hx, lp["wC"]).float()
    dt = softplus(dense(hx, lp["wdt"]).float() + lp["dt_bias"].float())

    xin, conv_new = _causal_conv(xin, lp["conv_w"], lp["conv_bias"],
                                 state.conv)
    xh = split_heads(xin, h)
    a_log = -torch.exp(torch.clamp(lp["A_log"].float(), -8.0, 6.0))
    y, s_new = ssd_chunked(xh, Bc, Cc, dt, a_log, state.s, cfg.seq_chunk)
    y = y + lp["skip_D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_in)
    y = rms_norm((y.float() * F.silu(z.float())).to(COMPUTE_DTYPE),
                 lp["gn_scale"], cfg.norm_eps)
    out = dense(y, lp["out_proj"])
    return x + out, MambaState(conv_new, s_new)


def mamba_state_specs(cfg: ModelConfig, batch: int,
                      prefix_shape: Tuple[int, ...]) -> MambaState:
    d_in, h, n = _dims(cfg)
    return MambaState(
        spec(*prefix_shape, batch, cfg.conv_width - 1, d_in,
             dtype=COMPUTE_DTYPE),
        spec(*prefix_shape, batch, h, n, cfg.ssm_head_dim,
             dtype=torch.float32))


# ---------------------------------------------------------------------------
# Zamba2 hybrid stack

def _zamba_shape(cfg: ModelConfig) -> Tuple[int, int]:
    groups = cfg.n_layers // cfg.attn_period
    tail = cfg.n_layers - groups * cfg.attn_period
    return groups, tail


def shared_attn_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "attn_norm": spec(d),
        "attn": attn_param_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
        "mlp_norm": spec(d),
        "w1": spec(d, cfg.d_ff), "w3": spec(d, cfg.d_ff),
        "w2": spec(cfg.d_ff, d),
    }


def param_specs(cfg: ModelConfig) -> dict:
    groups, tail = _zamba_shape(cfg)
    p = {
        "embed": spec(cfg.vocab_padded, cfg.d_model),
        "mamba": mamba_param_specs(cfg, (groups, cfg.attn_period)),
        "shared_attn": shared_attn_specs(cfg),
        "final_norm": spec(cfg.d_model),
        "lm_head": spec(cfg.d_model, cfg.vocab_padded),
    }
    if tail:
        p["mamba_tail"] = mamba_param_specs(cfg, (tail,))
    return p


def _shared_block(x, sp, cfg: ModelConfig, cache: Optional[KVCache],
                  pos, return_cache: bool):
    h = rms_norm(x, sp["attn_norm"], cfg.norm_eps)
    a, new_cache = attention(
        h, sp["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta, causal=True,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
        cache=cache, pos=pos, return_cache=return_cache)
    x = x + a
    h = rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    return x + swiglu(h, sp["w1"], sp["w3"], sp["w2"]), new_cache


def state_specs(cfg: ModelConfig, batch: int, cache_len: int) -> ZambaState:
    groups, tail = _zamba_shape(cfg)
    kv = spec(groups, batch, cache_len, cfg.n_kv_heads, cfg.hd,
              dtype=COMPUTE_DTYPE)
    return ZambaState(
        mamba=mamba_state_specs(cfg, batch, (groups, cfg.attn_period)),
        tail=mamba_state_specs(cfg, batch, (max(tail, 1),)),
        attn=KVCache(kv, kv),
        pos=spec(dtype=torch.int32))


def init_state(cfg: ModelConfig, batch: int, cache_len: int,
               device=None) -> ZambaState:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    state_specs(cfg, batch, cache_len))


def _mamba_stack(x, layers: dict, states: MambaState, cfg: ModelConfig):
    """Mamba2 blocks in order over a stacked parameter tree and states;
    returns the last hidden state and the new stacked states."""
    def body(h, layer):
        lp, st = layer
        return mamba_block(h, lp, cfg, st)

    x, news = run_layers(x, (layers, states), cfg, body, remat=False)
    return x, MambaState(*(torch.stack(t) for t in zip(*news)))


def _run_stack(params, x, cfg: ModelConfig, state: ZambaState, *,
               mode: str, pos=None):
    """mode: 'train' (no caches), 'prefill' (fill caches), 'decode'."""
    groups, tail = _zamba_shape(cfg)
    decode = mode == "decode"
    sp = params["shared_attn"]

    def group_body(h, group):
        mp, mstate, kv = group
        h, mstates = _mamba_stack(h, mp, mstate, cfg)
        h, new_cache = _shared_block(h, sp, cfg, kv if decode else None,
                                     pos, return_cache=mode == "prefill")
        return h, (mstates, new_cache)

    x, outs = run_layers(x, (params["mamba"], state.mamba, state.attn), cfg,
                         group_body, remat=cfg.remat and mode == "train")
    mstates = MambaState(*(torch.stack(t) for t in zip(*(m for m, _ in outs))))
    if mode == "prefill":
        kvs = KVCache(*(torch.stack(t) for t in zip(*(kv for _, kv in outs))))
    else:      # decode wrote its group slices in place; train reads none
        kvs = state.attn

    new_tail = state.tail
    if tail:
        x, new_tail = _mamba_stack(x, params["mamba_tail"], state.tail, cfg)

    if pos is None:
        new_pos = state.pos
    else:
        new_pos = torch.as_tensor(pos, device=x.device).to(torch.int32) + 1
    return x, ZambaState(mamba=mstates, tail=new_tail, attn=kvs, pos=new_pos)


def forward(params, tokens, cfg: ModelConfig):
    x = embed(params, tokens)
    state = init_state(cfg, tokens.shape[0], 8, x.device)
    x, _ = _run_stack(params, x, cfg, state, mode="train")
    return lm_logits(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    logits = forward(params, batch["tokens"], cfg)
    return softmax_cross_entropy(logits, batch["labels"])


def prefill(params, tokens, cfg: ModelConfig,
            cache_len: Optional[int] = None):
    b, s = tokens.shape
    cache_len = cache_len or s
    x = embed(params, tokens)
    state = init_state(cfg, b, cache_len, x.device)
    x, state = _run_stack(params, x, cfg, state, mode="prefill")

    def pad(c):    # the prefill caches padded to cache_len
        return F.pad(c, (0, 0, 0, 0, 0, cache_len - s)) \
            if c.shape[2] < cache_len else c

    state = state._replace(
        attn=KVCache(pad(state.attn.k), pad(state.attn.v)),
        pos=torch.tensor(s, dtype=torch.int32, device=x.device))
    return lm_logits(params, x[:, -1:, :], cfg), state


def decode_step(params, token, pos, state: ZambaState, cfg: ModelConfig):
    """One decode step at ``pos``: the Mamba states are new tensors, the
    attention caches are written in place at ``pos``; the state's ``pos``
    becomes ``pos + 1``."""
    x = embed(params, token[:, None])
    x, state = _run_stack(params, x, cfg, state, mode="decode", pos=pos)
    return lm_logits(params, x, cfg), state
