"""Plain PyTorch versions of the Hopper kernels (the oracles).

``spinner_scores_ref`` is ComputeScores by scatter-add; ``propose_ref``
is the per-vertex half of the update (Eq. 7-8: normalise, penalty,
current-label bonus, tie-noise argmax, M(l) partial) in the reference's
op order; ``fused_propose_ref`` composes the two and is what the fused
kernel computes, ``frontier_propose_ref`` what its frontier variant
computes (inactive rows write a no-op proposal).  Both read an optional
second edge segment, the on-device delta of appended entries.  Every one
gathers neighbour labels from ``lookup`` (default: ``labels``): on a shard
of the sharded engine the rows' own labels are the rank's label shard and
``dst`` indexes the exchange plan's lookup.  ``fused_propose_ref``'s
``acc_init`` seeds the score rows with an interior partial, what the fused
kernel's seeded form computes under the overlap schedule, and
``interior_partial_ref`` is that partial (the score kernel over the
interior segment, whose dst are local ids into the label shard).  The CPU
path and the tests use these; on a card the wrappers in
``spinner_scores`` launch the kernels instead.

Every score sum of the Eq. 3 weights (1 or 2) is an exact integer in
float32, so any accumulation order gives the same bits and the kernels
are held to these versions bit for bit; so are sums of halves.  Other
float weights round in each side's own order, and the kernels are held
to these versions within a tolerance there.

``pregel_reduce_ref`` / ``pregel_combine_ref`` are the Pregel message
combine (``pregel_combine`` kernels): a segmented sum (``index_add_``) or
min (``scatter_reduce_`` with ``"amin"``) of the gathered messages per
CSR row, and the vertex update after it.  The min is order-free, so the
kernels match it bit for bit; the float32 sum rounds in another order
than a kernel's, which is held to it within a tolerance.
"""
from __future__ import annotations

import numpy as np
import torch

INF_I32 = 2 ** 30   # "unreached" / min identity; INF_I32 + 1 fits in int32


def csr_src(row_ptr: torch.Tensor) -> torch.Tensor:
    """The int32 source id of every CSR entry (COO expansion)."""
    v = row_ptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(v, dtype=torch.int32, device=row_ptr.device),
        row_ptr[1:] - row_ptr[:-1])


def spinner_scores_ref(lookup: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, w: torch.Tensor,
                       num_vertices: int, k: int,
                       delta: tuple = (), init=None) -> torch.Tensor:
    """ComputeScores by scatter-add: scores[u, lookup[v]] += w(u, v), over
    the edge list and then the ``delta`` list ``(src, dst, w)`` of appended
    entries, if any (parallel edges carrying weight changes), starting from
    a copy of ``init`` (a (num_vertices, k) partial) or from zeros."""
    out = (torch.zeros((num_vertices, k), dtype=torch.float32,
                       device=lookup.device)
           if init is None else init.clone())
    for s, d, we in [(src, dst, w)] + ([tuple(delta)] if delta else []):
        out.index_put_((s.long(), lookup[d.long()].long()), we,
                       accumulate=True)
    return out


def interior_partial_ref(labels_local: torch.Tensor, row_ptr: torch.Tensor,
                         dst_local: torch.Tensor, w: torch.Tensor,
                         k: int) -> torch.Tensor:
    """The overlap schedule's interior partial: scores over a shard's
    interior CSR, whose dst are local ids into the label shard."""
    return spinner_scores_ref(labels_local, csr_src(row_ptr), dst_local, w,
                              row_ptr.shape[0] - 1, k)


def propose_ref(scores: torch.Tensor, labels: torch.Tensor,
                deg_w: torch.Tensor, pen: torch.Tensor, noise: torch.Tensor,
                valid: torch.Tensor, k: int, current_bonus: float,
                degree_weighted: bool) -> tuple:
    """Eq. 7-8 proposal from a dense (V, k) score matrix.

    ``pen`` is the (k,) penalty ``loads / C``.  Returns ``(best,
    tot_best, tot_cur, m_partial)``: the first-match argmax of
    ``(total + noise) + bonus``, the Eq. 8 total at the proposal and at
    the current label, and the (k,) migration-candidate mass M(l) over
    valid vertices whose proposal differs from their label.
    """
    norm = scores / torch.clamp(deg_w, min=1.0)[:, None]
    total = norm - pen[None, :]
    bonus = torch.nn.functional.one_hot(labels.long(), k).to(
        torch.float32) * float(np.float32(current_bonus))
    best = torch.argmax(total + noise + bonus, dim=1).to(torch.int32)
    want = (best != labels) & valid
    measure = deg_w if degree_weighted else torch.ones_like(deg_w)
    m_partial = torch.zeros(k, dtype=torch.float32, device=scores.device)
    m_partial.index_add_(0, best.long(), torch.where(want, measure, 0.0))
    tot_best = total.gather(1, best.long()[:, None])[:, 0]
    tot_cur = total.gather(1, labels.long()[:, None])[:, 0]
    return best, tot_best, tot_cur, m_partial


def fused_propose_ref(labels: torch.Tensor, src: torch.Tensor,
                      dst: torch.Tensor, w: torch.Tensor,
                      deg_w: torch.Tensor, pen: torch.Tensor,
                      noise: torch.Tensor, num_real: int, k: int,
                      current_bonus: float, degree_weighted: bool,
                      delta: tuple = (), lookup=None,
                      acc_init=None) -> tuple:
    """What the fused kernel computes: scores, then ``propose_ref``.

    Vertices ``>= num_real`` are padding: they propose like any other
    vertex but are left out of M(l).  ``delta`` and ``acc_init`` (the
    seeded form's (V, k) interior partial) as ``spinner_scores_ref``'s
    ``delta`` and ``init``; neighbours' labels come from ``lookup``.
    """
    v = labels.shape[0]
    scores = spinner_scores_ref(labels if lookup is None else lookup, src,
                                dst, w, v, k, delta, init=acc_init)
    valid = torch.arange(v, device=labels.device) < num_real
    return propose_ref(scores, labels, deg_w, pen, noise, valid, k,
                       current_bonus, degree_weighted)


def frontier_propose_ref(labels: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, w: torch.Tensor,
                         deg_w: torch.Tensor, pen: torch.Tensor,
                         noise: torch.Tensor, valid: torch.Tensor, k: int,
                         current_bonus: float, degree_weighted: bool,
                         delta: tuple = (), lookup=None) -> tuple:
    """What the fused kernel's frontier variant computes.

    ``valid`` is the frontier mode's ``real & active`` mask.  Rows inside
    it propose as in ``fused_propose_ref``; rows outside it are inactive
    and get ``best = labels``, ``tot_best = tot_cur = 0``.  M(l) counts
    only rows in ``valid`` whose proposal differs from their label.
    """
    v = labels.shape[0]
    scores = spinner_scores_ref(labels if lookup is None else lookup, src,
                                dst, w, v, k, delta)
    best, tot_best, tot_cur, m_partial = propose_ref(
        scores, labels, deg_w, pen, noise, valid, k, current_bonus,
        degree_weighted)
    return (torch.where(valid, best, labels),
            torch.where(valid, tot_best, 0.0),
            torch.where(valid, tot_cur, 0.0), m_partial)


def pregel_reduce_ref(send: torch.Tensor, row_ptr: torch.Tensor,
                      dst: torch.Tensor, *, combine: str, bias: int = 0,
                      acc_init=None) -> torch.Tensor:
    """Per CSR row v, the ``combine`` ("sum" f32 or "min" int32) of
    ``send[dst[e]] + bias`` over v's edges, folded into ``acc_init[v]``
    (default: the identity, 0 or ``INF_I32``)."""
    rows = row_ptr.shape[0] - 1
    msg = send[dst.long()]
    if bias:
        msg = msg + bias
    src = csr_src(row_ptr).long()
    if combine == "sum":
        acc = (torch.zeros(rows, dtype=torch.float32, device=send.device)
               if acc_init is None else acc_init.clone())
        return acc.index_add_(0, src, msg)
    if combine != "min":
        raise ValueError(f"unknown combine {combine!r}; available: sum, min")
    acc = (torch.full((rows,), INF_I32, dtype=torch.int32, device=send.device)
           if acc_init is None else acc_init.clone())
    return acc.scatter_reduce_(0, src, msg, "amin")


def pregel_combine_ref(send: torch.Tensor, row_ptr: torch.Tensor,
                       dst: torch.Tensor, values: torch.Tensor,
                       valid: torch.Tensor, base: float, *, combine: str,
                       update: str, damping: float, bias: int = 0,
                       acc_init=None) -> tuple:
    """``pregel_reduce_ref`` then the vertex update; ``(new, chg)``.

    ``update="pagerank"`` (with the sum): ``new = base + damping * acc``
    on valid rows, 0 elsewhere, ``chg = valid``.  ``update="min"`` (with
    the min): ``new = min(values, acc)`` on valid rows, ``values``
    elsewhere, ``chg = (new != values) & valid``.  ``base`` is PageRank's
    float32 teleport term ``(1 - d) / N``.
    """
    if (combine, update) not in (("sum", "pagerank"), ("min", "min")):
        raise ValueError(f"combine {combine!r} takes no update {update!r}: "
                         "pair sum with pagerank, min with min")
    acc = pregel_reduce_ref(send, row_ptr, dst, combine=combine, bias=bias,
                            acc_init=acc_init)
    if update == "pagerank":
        return torch.where(valid, base + damping * acc, 0.0), valid.clone()
    new = torch.where(valid, torch.minimum(values, acc), values)
    return new, (new != values) & valid
