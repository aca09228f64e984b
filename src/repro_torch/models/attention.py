"""GQA attention: chunked (flash-style) prefill/train + cached decode.

The port of ``repro.models.attention``.  Long sequences never materialize
the (S, S) score matrix: queries and keys are processed in (chunk_q,
chunk_kv) blocks with an online-softmax accumulator, as the reference's
``lax.scan`` does.  The reference's custom VJP is the
``torch.autograd.Function`` :class:`_Flash`: its backward recomputes the
probability blocks (the reference's ``_flash_bwd_impl``), so autograd keeps
only (q, k, v, out, lse) and never a probability block.

A causal block whose keys all lie after its queries is skipped in both
directions: every one of its probabilities is exactly 0, so the
reference's update by it leaves the accumulators' bits unchanged.

The query heads of one KV head are the G rows of a (G * chunk_q) block,
so one product covers a KV head's group; dk and dv sum the group's
contributions in that product, in float32.

On a mesh, flash attention is a local map: every (batch row, head) is
independent, so q, k and v are redistributed to the batch over the data
axes and the KV heads over "model" where it divides them -- else the
query heads, each rank reading its groups' KV heads from k and v whole on
"model" -- unless ``replicate_heads`` (the reference's ``attn_replicate``)
keeps the heads whole on every rank; each rank runs :class:`_Flash` on its
own rows and heads.  Its block loops and in-place accumulators have no
DTensor strategy; on one device the local map is the identity.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..parallel.constraints import (BATCH, constrain, is_dtensor, local_map,
                                    redistribute, split_heads)
from .common import (COMPUTE_DTYPE, apply_rope, cast, dense, matmul_f32,
                     rope_angles, spec)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, KV, hd)
    v: torch.Tensor          # (B, S_max, KV, hd)


def _q_blocks(x: torch.Tensor, kvh: int, chunk_q: int) -> torch.Tensor:
    """(B, Sq, H, hd) -> (nq, B, KV, G * Cq, hd): a KV head's G query heads
    stacked as the rows of each chunk."""
    b, sq, h, hd = x.shape
    g = h // kvh
    return (x.reshape(b, sq // chunk_q, chunk_q, kvh, g, hd)
            .permute(1, 0, 3, 4, 2, 5).reshape(sq // chunk_q, b, kvh,
                                               g * chunk_q, hd))


def _q_unblock(xc: torch.Tensor, b: int, sq: int, h: int) -> torch.Tensor:
    """Inverse of :func:`_q_blocks`."""
    nq, _, kvh, gc, hd = xc.shape
    g = h // kvh
    return (xc.reshape(nq, b, kvh, g, gc // g, hd)
            .permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hd))


def _block_kind(causal: bool, q_lo: int, q_hi: int, k_lo: int,
                k_hi: int) -> str:
    """'skip' (every key after every query), 'full' (no key after any
    query) or 'mask' for the causal block of query positions [q_lo, q_hi]
    and key positions [k_lo, k_hi]."""
    if not causal or k_hi <= q_lo:
        return "full"
    return "skip" if k_lo > q_hi else "mask"


def _scores(qblk, kblk, scale, kind, qpos, kpos, g):
    """(B, KV, G * Cq, Ckv) masked logits block, float32."""
    s = matmul_f32(qblk, kblk.transpose(-1, -2)) * scale
    if kind == "mask":
        mask = (kpos[None, :] <= qpos[:, None]).repeat(g, 1)
        s = torch.where(mask, s, NEG_INF)
    return s


def _flash_fwd(q, k, v, causal, chunk_q, chunk_kv, q_offset):
    """Returns (out (B, Sq, H, hd) bf16, lse (B, KV, G, Sq) float32)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    nq, nk = sq // chunk_q, skv // chunk_kv
    qc = _q_blocks(q, kvh, chunk_q)
    kc = k.permute(0, 2, 1, 3)                       # (B, KV, Skv, hd)
    vc = v.permute(0, 2, 1, 3)
    dev = q.device
    outs, lses = [], []
    for iq in range(nq):
        qblk = qc[iq]
        q_lo = q_offset + iq * chunk_q
        qpos = q_lo + torch.arange(chunk_q, device=dev)
        m = torch.full(qblk.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(qblk.shape, dtype=torch.float32, device=dev)
        for jk in range(nk):
            k_lo = jk * chunk_kv
            kind = _block_kind(causal, q_lo, q_lo + chunk_q - 1, k_lo,
                               k_lo + chunk_kv - 1)
            if kind == "skip":
                continue
            kpos = k_lo + torch.arange(chunk_kv, device=dev)
            kblk = kc[:, :, k_lo:k_lo + chunk_kv]
            vblk = vc[:, :, k_lo:k_lo + chunk_kv]
            s = _scores(qblk, kblk, scale, kind, qpos, kpos, g)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = matmul_f32(p.to(COMPUTE_DTYPE), vblk)
            acc = acc * corr[..., None] + pv
            m = m_new
        lsafe = torch.clamp_min(l, 1e-30)
        outs.append((acc / lsafe[..., None]).to(COMPUTE_DTYPE))
        lses.append(m + torch.log(lsafe))
    out = _q_unblock(torch.stack(outs), b, sq, h)
    lse = (torch.stack(lses).reshape(nq, b, kvh, g, chunk_q)
           .permute(1, 2, 3, 0, 4).reshape(b, kvh, g, sq))
    return out, lse


def _flash_bwd_impl(q, k, v, out, lse, dout, causal, chunk_q, chunk_kv,
                    q_offset):
    """The flash backward: recompute p blockwise.

    dq accumulates along each q chunk's key blocks; dk / dv are full-size
    float32 accumulators updated block by block."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    nq, nk = sq // chunk_q, skv // chunk_kv
    dev = q.device
    qc = _q_blocks(q, kvh, chunk_q)
    doc = _q_blocks(dout, kvh, chunk_q)
    outc = _q_blocks(out, kvh, chunk_q)
    lsec = (lse.reshape(b, kvh, g, nq, chunk_q).permute(3, 0, 1, 2, 4)
            .reshape(nq, b, kvh, g * chunk_q))
    kc = k.permute(0, 2, 1, 3)
    vc = v.permute(0, 2, 1, 3)
    dk_all = torch.zeros(b, kvh, skv, hd, dtype=torch.float32, device=dev)
    dv_all = torch.zeros_like(dk_all)
    dqs = []
    for iq in range(nq):
        qblk, dblk, lseb = qc[iq], doc[iq], lsec[iq]
        q_lo = q_offset + iq * chunk_q
        qpos = q_lo + torch.arange(chunk_q, device=dev)
        delta = torch.sum(dblk.float() * outc[iq].float(), dim=-1)
        dq_acc = torch.zeros(qblk.shape, dtype=torch.float32, device=dev)
        for jk in range(nk):
            k_lo = jk * chunk_kv
            kind = _block_kind(causal, q_lo, q_lo + chunk_q - 1, k_lo,
                               k_lo + chunk_kv - 1)
            if kind == "skip":
                continue
            kpos = k_lo + torch.arange(chunk_kv, device=dev)
            kblk = kc[:, :, k_lo:k_lo + chunk_kv]
            vblk = vc[:, :, k_lo:k_lo + chunk_kv]
            s = _scores(qblk, kblk, scale, kind, qpos, kpos, g)
            p = torch.exp(s - lseb[..., None])
            dp = matmul_f32(dblk, vblk.transpose(-1, -2))
            ds = p * (dp - delta[..., None])
            dsc = ds.to(COMPUTE_DTYPE)
            dq_acc = dq_acc + matmul_f32(dsc, kblk) * scale
            dk_all[:, :, k_lo:k_lo + chunk_kv] += (
                matmul_f32(dsc.transpose(-1, -2), qblk) * scale)
            dv_all[:, :, k_lo:k_lo + chunk_kv] += matmul_f32(
                p.to(COMPUTE_DTYPE).transpose(-1, -2), dblk)
        dqs.append(dq_acc)
    dq = _q_unblock(torch.stack(dqs), b, sq, h)
    dk = dk_all.permute(0, 2, 1, 3)
    dv = dv_all.permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Flash attention with the blockwise-recompute backward (the
    reference's ``jax.custom_vjp`` ``_flash``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk_q, chunk_kv, q_offset):
        out, lse = _flash_fwd(q, k, v, causal, chunk_q, chunk_kv, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, chunk_q, chunk_kv, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def _flash_local(q, k, v, replicate_heads, *args):
    """:class:`_Flash` on each rank's batch rows and heads of DTensor q, k,
    v (``constraints.local_map``).  "model" splits the KV heads where it
    divides them; else the query heads, where it divides them into whole
    groups or whole groups into them, each rank taking the KV heads of its
    query heads from k and v whole on "model"; else nothing."""
    h, kvh = q.shape[2], k.shape[2]
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    m = mesh.size(names.index("model")) if "model" in names else 1
    g = h // kvh
    hq = h // m
    if replicate_heads or m == 1 or kvh % m == 0 or h % m or (
            g % hq and hq % g):
        return local_map(lambda a, b, c: _Flash.apply(a, b, c, *args),
                         (q, k, v), [(0, 2)] * 3, [(0, 2)], heads=kvh,
                         replicate_heads=replicate_heads)
    j = mesh.get_coordinate()[names.index("model")]
    lo, hi = j * hq // g, ((j + 1) * hq - 1) // g + 1

    def local(a, b, c):
        return _Flash.apply(a, b[:, :, lo:hi], c[:, :, lo:hi], *args)

    return local_map(local, (q, k, v), [(0, 2), (0, None), (0, None)],
                     [(0, 2)], heads=h)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk_q: int, chunk_kv: int,
                      q_offset: int = 0, replicate_heads: bool = False
                      ) -> torch.Tensor:
    """Flash attention: q (B, Sq, H, hd); k, v (B, Skv, KV, hd) -> bf16
    (B, Sq, H, hd).

    Never materializes (Sq, Skv); the backward recomputes probability
    blocks, so autograd stores only (q, k, v, out, lse).  Chunk lengths
    that do not divide a length fall back to their gcd with it, as the
    reference's do.
    """
    sq, skv = q.shape[1], k.shape[1]
    chunk_q = math.gcd(min(chunk_q, sq), sq)
    chunk_kv = math.gcd(min(chunk_kv, skv), skv)
    if is_dtensor(q):
        return _flash_local(q, k, v, replicate_heads, causal, chunk_q,
                            chunk_kv, q_offset)
    return _Flash.apply(q, k, v, causal, chunk_q, chunk_kv, q_offset)


def _seq_slice(buf: torch.Tensor) -> Tuple[int, int]:
    """(offset, length) of this rank's slice of a DTensor cache's sequence
    dimension (1): ``torch.chunk``'s split on each mesh dimension that
    shards it, in mesh order."""
    from torch.distributed.tensor import Shard
    mesh, coord = buf.device_mesh, buf.device_mesh.get_coordinate()
    off, length = 0, buf.shape[1]
    for j, p in enumerate(buf.placements):
        if isinstance(p, Shard) and p.dim == 1:
            piece = -(-length // mesh.size(j))
            first = min(coord[j] * piece, length)
            off, length = off + first, min(piece, length - first)
    return off, length


def _decode_attention_mesh(q, cache: KVCache, pos) -> torch.Tensor:
    """:func:`decode_attention` against a DTensor cache, which
    ``rules.cache_shardings`` may shard along the sequence: each rank
    scores its own positions, and the softmax's max and sum and the
    output's sum are all-reduced over the mesh dimensions that shard the
    sequence (flash-decode).  q takes the cache's batch and head
    placements."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, place = cache.k.device_mesh, cache.k.placements
    seq = [mesh.get_group(j) for j, p in enumerate(place)
           if isinstance(p, Shard) and p.dim == 1]
    qplace = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
              for p in place]
    ql = redistribute(q, qplace).to_local()
    kl, vl = cache.k.to_local(), cache.v.to_local()
    off, _ = _seq_slice(cache.k)
    b, _, h, hd = ql.shape
    kvh = kl.shape[2]
    qh = cast(ql).reshape(b, kvh, h // kvh, hd)
    s = matmul_f32(qh, cast(kl).permute(0, 2, 3, 1)) * hd ** -0.5
    mask = off + torch.arange(kl.shape[1], device=kl.device) <= pos
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    for g in seq:
        m = funcol.all_reduce(m, "max", g)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    for g in seq:
        den = funcol.all_reduce(den, "sum", g)
    out = matmul_f32((e / den).to(COMPUTE_DTYPE),
                     cast(vl).permute(0, 2, 1, 3))
    for g in seq:
        out = funcol.all_reduce(out, "sum", g)
    out = out.reshape(b, 1, h, hd).to(COMPUTE_DTYPE).contiguous()
    return DTensor.from_local(out, mesh, qplace, run_check=False)


def decode_attention(q: torch.Tensor, cache: KVCache, pos) -> torch.Tensor:
    """One-token attention against a cache: q (B, 1, H, hd), pos an int
    (or a 0-d tensor).  Positions > pos are masked; the current token must
    already be written."""
    if is_dtensor(cache.k):
        return _decode_attention_mesh(q, cache, pos)
    b, _, h, hd = q.shape
    smax, kvh = cache.k.shape[1], cache.k.shape[2]
    g = h // kvh
    qh = cast(q).reshape(b, kvh, g, hd)
    s = matmul_f32(qh, cast(cache.k).permute(0, 2, 3, 1)) * hd ** -0.5
    mask = torch.arange(smax, device=q.device) <= pos
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE)
    out = matmul_f32(p, cast(cache.v).permute(0, 2, 1, 3))   # (B,KV,G,hd)
    return out.reshape(b, 1, h, hd).to(COMPUTE_DTYPE)


def _write_cache(buf: torch.Tensor, start: int, val: torch.Tensor) -> None:
    """``buf[:, start:start + n] = val`` in place (n = ``val.shape[1]``).
    For a DTensor cache, sharded along the sequence as
    ``rules.cache_shardings`` may shard it, each rank writes the positions
    of its own slice: DTensor has no in-place write into a slice of a
    sharded dimension."""
    n = val.shape[1]
    if not is_dtensor(buf):
        buf[:, start:start + n] = val
        return
    from torch.distributed.tensor import Replicate, Shard
    local = redistribute(val, [Replicate() if isinstance(p, Shard) and
                               p.dim == 1 else p
                               for p in buf.placements]).to_local()
    off, length = _seq_slice(buf)
    lo, hi = max(start, off), min(start + n, off + length)
    if lo < hi:
        buf.to_local()[:, lo - off:hi - off] = local[:, lo - start:hi - start]


def _positions(pos, device) -> torch.Tensor:
    """``pos`` as a (1,) position tensor; an int makes no host copy."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device)
    return torch.arange(pos, pos + 1, device=device)


def attention(x: torch.Tensor, p: dict, *, n_heads: int, n_kv_heads: int,
              head_dim: int, rope_theta: Optional[float], causal: bool,
              chunk_q: int, chunk_kv: int,
              memory: Optional[torch.Tensor] = None,
              cache: Optional[KVCache] = None,
              pos=None,
              return_cache: bool = False,
              bf16_wire: bool = False,
              replicate_heads: bool = False,
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Unified attention block over params {wq, wk, wv, wo [, bq, bk, bv]}.

    - self-attn train/prefill: memory=None, cache=None
    - cross-attn: memory = encoder/image states (keys/values source)
    - decode: cache + pos given; x is the (B, 1, d) current token.  The
      token's k / v are written into ``cache`` in place at ``pos`` (the
      reference's serving loop donates the cache, so its update is in place
      too) and the same cache is returned.

    ``replicate_heads`` (the reference's ``attn_replicate``) gathers q, k
    and v whole over "model" before the flash blocks; the identity on one
    device.
    """
    b, sq, _ = x.shape
    kv_src = x if memory is None else memory
    q = split_heads(dense(x, p["wq"], p.get("bq")), n_heads)

    if cache is not None and memory is not None:
        # cross-attn during decode: cache holds the projected memory
        out = decode_attention(q, cache, cache.k.shape[1] - 1)
        return dense(out.reshape(b, sq, -1), p["wo"],
                     bf16_wire=bf16_wire), cache

    k = split_heads(dense(kv_src, p["wk"], p.get("bk")), n_kv_heads)
    v = split_heads(dense(kv_src, p["wv"], p.get("bv")), n_kv_heads)

    if cache is not None:                          # self-attn decode
        assert pos is not None
        if rope_theta:
            angles = rope_angles(_positions(pos, x.device), head_dim,
                                 rope_theta)
            q = apply_rope(q, angles)
            k = apply_rope(k, angles)
        # dynamic_update_slice's clamp: the slice always fits
        start = min(max(int(pos), 0), cache.k.shape[1] - sq)
        _write_cache(cache.k, start, cast(k))
        _write_cache(cache.v, start, cast(v))
        out = decode_attention(q, cache, pos)
        return dense(out.reshape(b, sq, -1), p["wo"],
                     bf16_wire=bf16_wire), cache

    if rope_theta and memory is None:
        angles = rope_angles(torch.arange(sq, device=x.device), head_dim,
                             rope_theta)
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)

    if replicate_heads:
        q = constrain(q, BATCH, None, None, None)
        k = constrain(k, BATCH, None, None, None)
        v = constrain(v, BATCH, None, None, None)
    out = chunked_attention(q, k, v, causal=causal, chunk_q=chunk_q,
                            chunk_kv=chunk_kv,
                            replicate_heads=replicate_heads)
    # heads merged per rank on a mesh: the backward then never unflattens
    # a dimension "model" splits unevenly by heads
    out = local_map(lambda o: o.reshape(*o.shape[:2], -1), (out,),
                    [(0, 2)], [(0, 2)], heads=n_heads,
                    replicate_heads=replicate_heads)
    out = dense(out, p["wo"], bf16_wire=bf16_wire)
    if return_cache:
        return out, KVCache(cast(k), cast(v))
    return out, None


def attn_param_specs(d_model: int, n_heads: int, n_kv_heads: int,
                     head_dim: int, qkv_bias: bool = False,
                     prefix_shape: Tuple[int, ...] = ()) -> dict:
    ps = prefix_shape
    p = {
        "wq": spec(*ps, d_model, n_heads * head_dim),
        "wk": spec(*ps, d_model, n_kv_heads * head_dim),
        "wv": spec(*ps, d_model, n_kv_heads * head_dim),
        "wo": spec(*ps, n_heads * head_dim, d_model),
    }
    if qkv_bias:
        p["bq"] = spec(*ps, n_heads * head_dim)
        p["bk"] = spec(*ps, n_kv_heads * head_dim)
        p["bv"] = spec(*ps, n_kv_heads * head_dim)
    return p
