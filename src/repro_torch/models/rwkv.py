"""RWKV6 "Finch": attention-free LM with data-dependent per-channel decay.

The port of ``repro.models.rwkv``.  Training/prefill uses the chunked
linear-attention formulation (GLA-style): within a chunk the pairwise
decay tensor D[t,s,c] = exp(la_ex[t,c] - la_in[s,c]) is formed explicitly
(exponents are <= 0, so it never overflows), the inter-chunk contribution
flows through a carried per-head state S (hd_k x hd_v), and chunks run in
order in a Python loop (the reference's ``lax.scan``), each chunk step
checkpointed when autograd records, as the reference's
``jax.checkpoint(step)``: a backward keeps only the carried states, never
a chunk's D.  Decode is the plain O(1) recurrence; ``wkv_ref`` is the
step-by-step oracle.

The reference's three-operand contraction ``"bthc,bshc,btshc->btsh"``
(P = sum_c r_t k_s D_ts) is written as the product ``(r_t * k_s) * D``
summed over c; its other contractions are two-operand ``einsum``s.  The
strictly lower-triangular mask is ``-inf`` before the ``exp``, so the
masked half is exactly 0 and its gradient 0, not NaN.

Simplifications of the reference against the released checkpoint, kept:
static token-shift lerp coefficients (the ddlerp LoRA only for the
decay), RMSNorm instead of LayerNorm.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..parallel.constraints import is_dtensor, local_map, split_heads
from .common import (COMPUTE_DTYPE, dense, rms_norm, softmax_cross_entropy,
                     spec)
from .dense import embed, lm_logits, run_layers


class RWKVState(NamedTuple):
    tm_last: torch.Tensor    # (L, B, d)   token-shift carry, time-mix
    cm_last: torch.Tensor    # (L, B, d)   token-shift carry, channel-mix
    s: torch.Tensor          # (L, B, H, hd, hd) wkv state, float32


def layer_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.ssm_head_dim
    h = d // hd
    lora = 64
    return {
        "ln1": spec(n_layers, d),
        "ln2": spec(n_layers, d),
        "mix_r": spec(n_layers, d), "mix_k": spec(n_layers, d),
        "mix_v": spec(n_layers, d), "mix_w": spec(n_layers, d),
        "mix_g": spec(n_layers, d),
        "wr": spec(n_layers, d, d), "wk": spec(n_layers, d, d),
        "wv": spec(n_layers, d, d), "wg": spec(n_layers, d, d),
        "wo": spec(n_layers, d, d),
        "decay0": spec(n_layers, d),
        "decay_a": spec(n_layers, d, lora),
        "decay_b": spec(n_layers, lora, d),
        "bonus_u": spec(n_layers, h, hd),
        "gn_scale": spec(n_layers, d),
        "mix_cr": spec(n_layers, d), "mix_ck": spec(n_layers, d),
        "cwk": spec(n_layers, d, f), "cwv": spec(n_layers, f, d),
        "cwr": spec(n_layers, d, d),
    }


def param_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": spec(cfg.vocab_padded, cfg.d_model),
        "layers": layer_param_specs(cfg, cfg.n_layers),
        "final_norm": spec(cfg.d_model),
        "lm_head": spec(cfg.d_model, cfg.vocab_padded),
    }


def _shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x_{t-1} along seq; position 0 uses the carried ``last`` token."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _log_decay(xw: torch.Tensor, lp: dict) -> torch.Tensor:
    """Data-dependent log decay, guaranteed < 0 (decay in (0, 1))."""
    lora = dense(torch.tanh(dense(xw, lp["decay_a"]).float()
                            ).to(COMPUTE_DTYPE), lp["decay_b"])
    return -torch.exp(torch.clamp(lp["decay0"].float() + lora.float(),
                                  -8.0, 6.0))


def _chunks(x: torch.Tensor, n: int, chunk: int) -> tuple:
    """(B, S, ...) -> the ``n`` chunks (B, chunk, ...) along S."""
    return torch.unbind(x.reshape(x.shape[0], n, chunk, *x.shape[2:]), 1)


def _wkv_step(S, rb, kb, vb, lwb, u):
    """One chunk: the carried state S (B, H, hd, hd) and the chunk's
    r/k/v/lw (B, C, H, hd) -> (S_new, out (B, C, H, hd) bf16)."""
    rb, kb, vb, lwb = (x.float() for x in (rb, kb, vb, lwb))
    c = rb.shape[1]
    la_in = torch.cumsum(lwb, dim=1)                  # inclusive (B,C,H,hd)
    la_ex = la_in - lwb                               # exclusive
    # inter-chunk: r_t decayed against the carried state
    inter = torch.einsum("bthc,bhcv->bthv", rb * torch.exp(la_ex), S)
    # intra-chunk, strictly lower-triangular via pairwise decays
    dmat = la_ex[:, :, None] - la_in[:, None, :]      # (B,C,C,H,hd) t,s
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=S.device),
                     diagonal=-1)
    dmat = torch.where(tri[None, :, :, None, None], dmat, -torch.inf)
    P = ((rb[:, :, None] * kb[:, None, :]) * torch.exp(dmat)).sum(-1)
    intra = torch.einsum("btsh,bshv->bthv", P, vb)
    # diagonal bonus term
    sig = (rb * u.float() * kb).sum(-1)               # (B,C,H)
    out = inter + intra + sig[..., None] * vb
    # carry the state across the chunk
    tail = la_in[:, -1:]                              # (B,1,H,hd)
    S_new = (torch.exp(tail[:, 0])[..., None] * S
             + torch.einsum("bshc,bshv->bhcv", kb * torch.exp(tail - la_in),
                            vb))
    return S_new, out.to(COMPUTE_DTYPE)


def wkv_chunked(r, k, v, lw, u, s0, chunk: int):
    """Chunked WKV. r/k/v/lw: (B, S, H, hd); u: (H, hd); s0: (B, H, hd, hd).

    Recurrence: out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);
                S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T.
    Returns (out (B, S, H, hd) bf16, s_final float32).  ``S`` must be a
    multiple of ``min(chunk, S)``, as the reference asserts.  On a mesh
    each rank scans its own batch rows and heads (``local_map``).
    """
    if is_dtensor(r):
        return local_map(lambda *a: wkv_chunked(*a, chunk),
                         (r, k, v, lw, u, s0), [(0, 2)] * 4 + [(None, 0),
                                                          (0, 1)],
                         [(0, 2), (0, 1)], heads=r.shape[2])
    b, s, h, hd = r.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    n = s // chunk
    S = s0.float()
    remat = torch.is_grad_enabled()
    outs = []
    for xs in zip(*(_chunks(x, n, chunk) for x in (r, k, v, lw))):
        if remat:
            S, out = checkpoint(_wkv_step, S, *xs, u, use_reentrant=False)
        else:
            S, out = _wkv_step(S, *xs, u)
        outs.append(out)
    return torch.stack(outs, 1).reshape(b, s, h, hd), S


def wkv_ref(r, k, v, lw, u, s0):
    """Step-by-step oracle for tests."""
    S = s0.float()
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = (x[:, t].float() for x in (r, k, v, lw))
        kv = torch.einsum("bhc,bhv->bhcv", kt, vt)
        outs.append(torch.einsum("bhc,bhcv->bhv", rt, S + uf * kv))
        S = torch.exp(lwt)[..., None] * S + kv
    return torch.stack(outs, 1).to(COMPUTE_DTYPE), S


def _head_groupnorm(x: torch.Tensor, scale: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Per-head RMS normalization; x: (B, S, H, hd), scale: (d,)."""
    b, s, h, hd = x.shape
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps)).reshape(b, s, h * hd)
    return (out * scale.float()).to(COMPUTE_DTYPE)


def time_mix(x, last, lp, cfg: ModelConfig, s0):
    """Returns (out, new_last, s_final). x: (B, S, d)."""
    b, s, d = x.shape
    hd = cfg.ssm_head_dim
    h = d // hd
    xx = _shift(x, last)

    def lerp(mix):
        return x + (xx - x) * mix.to(x.dtype)

    r = split_heads(dense(lerp(lp["mix_r"]), lp["wr"]), h)
    k = split_heads(dense(lerp(lp["mix_k"]), lp["wk"]), h)
    v = split_heads(dense(lerp(lp["mix_v"]), lp["wv"]), h)
    g = dense(lerp(lp["mix_g"]), lp["wg"])
    lw = split_heads(_log_decay(lerp(lp["mix_w"]), lp), h)

    out, s_fin = wkv_chunked(r, k, v, lw, lp["bonus_u"], s0, cfg.seq_chunk)
    out = _head_groupnorm(out, lp["gn_scale"], cfg.norm_eps)
    out = out * F.silu(g.float()).to(COMPUTE_DTYPE)
    return dense(out, lp["wo"]), x[:, -1, :], s_fin


def channel_mix(x, last, lp):
    xx = _shift(x, last)

    def lerp(mix):
        return x + (xx - x) * mix.to(x.dtype)

    k = dense(lerp(lp["mix_ck"]), lp["cwk"]).float()
    k = torch.square(torch.relu(k)).to(COMPUTE_DTYPE)
    rgate = torch.sigmoid(dense(lerp(lp["mix_cr"]), lp["cwr"]).float()
                          ).to(COMPUTE_DTYPE)
    return rgate * dense(k, lp["cwv"]), x[:, -1, :]


def _layer(x, lp, cfg: ModelConfig, state):
    tm_last, cm_last, s0 = state
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, tm_new, s_new = time_mix(h, tm_last, lp, cfg, s0)
    x = x + a
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    m, cm_new = channel_mix(h2, cm_last, lp)
    return x + m, (tm_new, cm_new, s_new)


def state_specs(cfg: ModelConfig, batch: int) -> RWKVState:
    d, hd = cfg.d_model, cfg.ssm_head_dim
    h = d // hd
    return RWKVState(
        spec(cfg.n_layers, batch, d, dtype=COMPUTE_DTYPE),
        spec(cfg.n_layers, batch, d, dtype=COMPUTE_DTYPE),
        spec(cfg.n_layers, batch, h, hd, hd, dtype=torch.float32))


def init_state(cfg: ModelConfig, batch: int, device=None) -> RWKVState:
    return RWKVState(*(torch.zeros(s.shape, dtype=s.dtype, device=device)
                       for s in state_specs(cfg, batch)))


def _run_stack(params, x, cfg: ModelConfig, state: RWKVState):
    """The layers in order, layer i from state slice i; returns the last
    hidden state and the new (stacked) state."""
    def body(h, layer):
        lp, st = layer
        return _layer(h, lp, cfg, st)

    x, news = run_layers(x, (params["layers"], state), cfg, body)
    return x, RWKVState(*(torch.stack(t) for t in zip(*news)))


def forward(params, tokens, cfg: ModelConfig):
    x = embed(params, tokens)
    state = init_state(cfg, tokens.shape[0], x.device)
    x, _ = _run_stack(params, x, cfg, state)
    return lm_logits(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    logits = forward(params, batch["tokens"], cfg)
    return softmax_cross_entropy(logits, batch["labels"])


def prefill(params, tokens, cfg: ModelConfig):
    x = embed(params, tokens)
    state = init_state(cfg, tokens.shape[0], x.device)
    x, state = _run_stack(params, x, cfg, state)
    return lm_logits(params, x[:, -1:, :], cfg), state


def decode_step(params, token, pos, state: RWKVState, cfg: ModelConfig):
    """O(1) recurrent decode; ``pos`` unused (the state is position-free,
    ``None`` is fine); returns a new state."""
    del pos
    x = embed(params, token[:, None])
    x, state = _run_stack(params, x, cfg, state)
    return lm_logits(params, x, cfg), state
