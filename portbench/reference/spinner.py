"""The plain reference of Spinner that decides ``correct``.

Plain PyTorch and NumPy, written from the paper (Sections 3.1-3.4) and
the repository's conventions, importing nothing of the program under
test.  It works out again everything the program derives from the
benchmark's inputs:

* the padded vertex count (``shape_bucket``): the tie-break noise is
  drawn over the padded vertex set, so the bucket is part of the
  trajectory;
* the weighted degrees and the Eq. 5 capacity;
* for ``adapt``, the graph after each batch of new edges (``PairLedger``:
  Eq. 3 weights under the union-of-directions rule of ``add_edges``, in
  which a weight-1 pair stands for its lo->hi direction);
* the whole run: threefry draws, scores, the Eq. 7-8 proposal, the
  Eq. 11-12 migrations and the Section 3.3 halt.

Every score sum of the Eq. 3 weights (1 or 2) is an integer below 2**24
(a row's weighted degree), exact in float32 in any order, so the scores
are scattered with ``index_add_``.  The sums over all vertices -- the
loads B(l), the migration-candidate mass M(l) and the load change --
are integers that can pass 2**24 on a large graph: they are summed
exactly (float64) and rounded once to float32, the value a float32 sum
takes in any order while it stays below 2**24.  The per-vertex arithmetic
keeps the repository's op order
(normalise, subtract the penalty, add the noise, add the current-label
bonus, first-match argmax), and score(G) is one ``sum`` of a float32
vector of the padded length, as the program takes it.  ``dtype`` other
than float32 computes the per-vertex arithmetic in that precision: the
control that the comparison has to fail.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import threefry

V_FLOOR = 64


def shape_bucket(n: int, floor: int = V_FLOOR) -> int:
    """The padded size of ``n``: the smallest ``m * 2**(e-2)`` (m in 5..8)
    at or above ``max(n, floor)``, so padding stays under 25%."""
    n = max(int(n), int(floor), 1)
    p = 1 << (n - 1).bit_length()
    half = p // 2
    step = max(half // 4, 1)
    for m in range(1, 5):
        if half + m * step >= n:
            return half + m * step
    return p


@dataclasses.dataclass(frozen=True)
class Params:
    """Spinner's parameters (Sections 3.1-3.3)."""

    k: int
    c: float = 1.05
    eps: float = 1e-3
    halt_window: int = 5
    max_iters: int = 300
    tie_noise: float = 1e-7
    current_bonus: float = 1e-6

    @classmethod
    def from_config(cls, spinner: dict) -> "Params":
        return cls(**{f.name: spinner[f.name]
                      for f in dataclasses.fields(cls) if f.name in spinner})


@dataclasses.dataclass
class Answer:
    """One run's result, as the comparison reads it."""

    labels: np.ndarray      # (V,) int32
    loads: np.ndarray       # (k,) float32
    iterations: int
    halted: bool


def float32_total(deg: np.ndarray) -> float:
    """The graph's total weight as the repository defines it: a float32
    NumPy sum of the weighted degrees (it rounds above 2**24)."""
    return float(np.ascontiguousarray(deg, np.float32).sum())


class Edges:
    """A symmetric weighted edge list on the device, with its degrees."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor,
                 w: torch.Tensor, num_vertices: int):
        self.src, self.dst, self.w = src.long(), dst.long(), w.float()
        self.num_vertices = int(num_vertices)
        self.v_pad = shape_bucket(num_vertices)
        self.deg = torch.zeros(self.v_pad, dtype=torch.float32,
                               device=src.device).index_add_(0, self.src,
                                                             self.w)


def exact_sum(index: torch.Tensor, values: torch.Tensor, k: int,
              minus: tuple = ()) -> torch.Tensor:
    """Per part l, the sum of ``values`` where ``index`` is l (less the
    sum of ``minus``'s values where its index is l), exact in float64,
    rounded once to float32."""
    out = torch.zeros(k, dtype=torch.float64, device=values.device)
    out.index_add_(0, index.long(), values.double())
    if minus:
        out.index_add_(0, minus[0].long(), -minus[1].double())
    return out.float()


def run(edges: Edges, params: Params, init: torch.Tensor, capacity: float,
        seed: int, dtype=torch.float32) -> Answer:
    """Spinner from ``init`` (real vertices' labels) to the halt or
    ``max_iters``, with the streams of ``seed`` and capacity ``capacity``
    (a Python float, made a float32 scalar as the program does)."""
    dev, k, v_pad = edges.src.device, params.k, edges.v_pad
    num_real = edges.num_vertices
    labels = torch.zeros(v_pad, dtype=torch.int32, device=dev)
    labels[:num_real] = init.to(device=dev, dtype=torch.int32)
    deg = edges.deg
    loads = exact_sum(labels, deg, k)
    C = torch.tensor(capacity, dtype=torch.float32, device=dev)
    valid = torch.arange(v_pad, device=dev) < num_real
    eps = float(np.float32(params.eps))
    bonus = float(np.float32(params.current_bonus))
    key = threefry.split(threefry.seed_key(seed))[0]
    best_score = torch.tensor(-np.inf, dtype=torch.float32, device=dev)
    stall, it, halted = 0, 0, False
    edge_row = edges.src * k
    while not halted and it < params.max_iters:
        key, k_it = threefry.split(key)
        k_noise, k_mig = threefry.split(k_it)
        noise = threefry.uniform(k_noise, v_pad * k, params.tie_noise,
                                 dev).view(v_pad, k)
        u = threefry.uniform(k_mig, v_pad, 1.0, dev)
        # ComputeScores (Eq. 7): integer sums, exact in any order
        scores = torch.zeros(v_pad * k, dtype=torch.float32, device=dev)
        scores.index_add_(0, edge_row + labels.long()[edges.dst], edges.w)
        scores = scores.view(v_pad, k)
        # Eq. 8: normalised score minus the load penalty, noise and bonus
        norm = scores.to(dtype) / torch.clamp(deg, min=1.0).to(dtype)[:, None]
        total = norm - (loads.to(dtype) / C.to(dtype))[None, :]
        cur = torch.nn.functional.one_hot(labels.long(), k).to(dtype) * bonus
        del scores, norm
        best = torch.argmax(total + noise.to(dtype) + cur,
                            dim=1).to(torch.int32)
        del noise, cur
        want = (best != labels) & valid
        M = exact_sum(best, torch.where(want, deg, 0.0), k)
        tot_best = total.gather(1, best.long()[:, None])[:, 0].float()
        tot_cur = total.gather(1, labels.long()[:, None])[:, 0].float()
        del total
        # ComputeMigrations (Eq. 11-12)
        R = torch.clamp(C - loads, min=0.0)
        p = torch.clamp(R / torch.clamp(M, min=1e-9), 0.0, 1.0)
        migrate = want & (u < p[best.long()])
        mig = torch.where(migrate, deg, 0.0)
        delta = exact_sum(best, mig, k, minus=(labels, mig))
        score_g = torch.where(valid, torch.where(migrate, tot_best, tot_cur),
                              0.0).sum()
        labels = torch.where(migrate, best, labels)
        loads = loads + delta
        # Section 3.3: halt after halt_window iterations without a gain
        tol = torch.clamp(best_score.abs(), min=1.0) * eps
        improved = bool(score_g > best_score + tol)
        best_score = torch.maximum(best_score, score_g)
        stall = 0 if improved else stall + 1
        halted = stall >= params.halt_window
        it += 1
    return Answer(labels=labels[:num_real].cpu().numpy(),
                  loads=loads.cpu().numpy(), iterations=it, halted=halted)


class PairLedger:
    """The graph after batches of new directed edges, pair by pair.

    Eq. 3: a pair's weight is the number of its directions present (1 or
    2).  Under ``add_edges`` a weight-1 pair stands for its lo->hi
    direction, so a batch makes a pair's weight ``[w0 >= 1 or the batch
    has lo->hi] + [w0 >= 2 or the batch has hi->lo]``.  The base pairs
    stay as they are; the pairs the batches changed are kept in a sorted
    overlay of keys ``lo * V + hi`` and their new weights.
    """

    def __init__(self, src: torch.Tensor, dst: torch.Tensor,
                 w: torch.Tensor, num_vertices: int):
        self.V = int(num_vertices)
        self.base = (src.long(), dst.long(), w.float())
        half = src < dst
        keys, order = torch.sort(src[half].long() * self.V + dst[half].long())
        self.base_keys = keys
        self.base_w = w[half].float()[order]
        dev = src.device
        self.keys = torch.zeros(0, dtype=torch.int64, device=dev)
        self.w = torch.zeros(0, dtype=torch.float32, device=dev)
        self.added = 0          # weight the batches added, over all pairs

    @staticmethod
    def _lookup(keys, table_keys, table_w):
        """The weights of ``keys`` in a sorted table (0 where absent)."""
        if table_keys.numel() == 0:
            return torch.zeros(keys.shape, dtype=torch.float32,
                               device=keys.device), \
                torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
        pos = torch.searchsorted(table_keys, keys).clamp_(
            max=table_keys.numel() - 1)
        found = table_keys[pos] == keys
        return torch.where(found, table_w[pos], 0.0), found

    def weights(self, keys: torch.Tensor) -> torch.Tensor:
        """The current weights of the pairs ``keys``."""
        w_new, in_overlay = self._lookup(keys, self.keys, self.w)
        w_base, _ = self._lookup(keys, self.base_keys, self.base_w)
        return torch.where(in_overlay, w_new, w_base)

    def add(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Fold one batch of directed edges into the ledger."""
        V = self.V
        src, dst = src.long(), dst.long()
        keep = src != dst
        directed = torch.unique(src[keep] * V + dst[keep])
        s, d = directed // V, directed % V
        pair = torch.minimum(s, d) * V + torch.maximum(s, d)
        pairs, inv = torch.unique(pair, return_inverse=True)
        count = torch.zeros(pairs.numel(), dtype=torch.int32,
                            device=src.device)
        lohi = count.index_add(0, inv, (s < d).int()) > 0
        hilo = count.index_add(0, inv, (s > d).int()) > 0
        w0 = self.weights(pairs)
        w1 = (((w0 >= 1) | lohi).float() + ((w0 >= 2) | hilo).float())
        grew = w1 > w0
        pairs, w1 = pairs[grew], w1[grew]
        self.added += int((w1 - w0[grew]).sum().item())
        keys = torch.cat([self.keys, pairs])
        ws = torch.cat([self.w, w1])
        keys, order = torch.sort(keys, stable=True)
        ws = ws[order]
        # a key twice: the later (this batch's) weight wins
        last = torch.ones_like(keys, dtype=torch.bool)
        last[:-1] = keys[1:] != keys[:-1]
        self.keys, self.w = keys[last], ws[last]

    def edges(self) -> Edges:
        """The merged graph as a symmetric edge list."""
        V = self.V
        src, dst, w = self.base
        pair = torch.minimum(src, dst) * V + torch.maximum(src, dst)
        w_new, in_overlay = self._lookup(pair, self.keys, self.w)
        w = torch.where(in_overlay, w_new, w)
        _, in_base = self._lookup(self.keys, self.base_keys, self.base_w)
        fresh, fw = self.keys[~in_base], self.w[~in_base]
        lo, hi = fresh // V, fresh % V
        return Edges(torch.cat([src, lo, hi]), torch.cat([dst, hi, lo]),
                     torch.cat([w, fw, fw]), V)

    def total_weight(self, base_total: float) -> float:
        """The capacity's total weight after the batches: the base total
        plus twice the weight the batches added to pairs (each pair is two
        directed entries).  The program's fast path accounts it so."""
        return base_total + 2.0 * self.added


def capacity(params: Params, total_weight: float) -> float:
    """C per Eq. 5, in weighted-degree units."""
    return params.c * total_weight / params.k


def host_edges(graph: dict, device, num_vertices: Optional[int] = None
               ) -> Edges:
    """``Edges`` of the benchmark's host graph arrays on ``device``."""
    return Edges(torch.from_numpy(graph["src"]).to(device),
                 torch.from_numpy(graph["dst"]).to(device),
                 torch.from_numpy(graph["weight"]).to(device),
                 graph["num_vertices"] if num_vertices is None
                 else num_vertices)
