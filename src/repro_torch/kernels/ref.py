"""Plain PyTorch versions of the Hopper kernels (the oracles).

``spinner_scores_ref`` is ComputeScores by scatter-add; ``propose_ref``
is the per-vertex half of the update (Eq. 7-8: normalise, penalty,
current-label bonus, tie-noise argmax, M(l) partial) in the reference's
op order; ``fused_propose_ref`` composes the two and is what the fused
kernel computes.  The CPU path and the tests use these; on a card the
wrappers in ``spinner_scores`` launch the kernels instead.

Every score sum is an exact integer in float32 (Eq. 3 weights are 1 or
2), so any accumulation order gives the same bits and the kernels are
held to these versions bit for bit.

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


def spinner_scores_ref(labels: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, w: torch.Tensor,
                       num_vertices: int, k: int) -> torch.Tensor:
    """ComputeScores by scatter-add: scores[u, labels[v]] += w(u, v)."""
    nbr = labels[dst.long()].long()
    out = torch.zeros((num_vertices, k), dtype=torch.float32,
                      device=labels.device)
    return out.index_put_((src.long(), nbr), w, accumulate=True)


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
                      current_bonus: float, degree_weighted: bool) -> tuple:
    """What the fused kernel computes: scores, then ``propose_ref``.

    Vertices ``>= num_real`` are padding: they propose like any other
    vertex but are left out of M(l).
    """
    v = labels.shape[0]
    scores = spinner_scores_ref(labels, src, dst, w, v, k)
    valid = torch.arange(v, device=labels.device) < num_real
    return propose_ref(scores, labels, deg_w, pen, noise, valid, k,
                       current_bonus, degree_weighted)


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
