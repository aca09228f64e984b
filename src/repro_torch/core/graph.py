"""Graph containers and preprocessing for Spinner (numpy, device-free).

A directed edge list is symmetrised into the weighted undirected form of
Eq. (3) -- w(u, v) = 2 when both directions exist, else 1 -- and stored
as a CSR-sorted symmetric COO list: every undirected edge {u, v} appears
as (u, v) and as (v, u).  ``shape_bucket`` / ``pad_graph`` give the
bucketed padded layout every engine runs on (the tie-break noise is drawn
over the PADDED vertex set, so the bucket is part of the trajectory), and
``Graph.to_device`` uploads the padded CSR once per device.

The Hopper kernels read the CSR directly (``row_ptr`` / ``dst`` /
``weight``): the TPU's tiled one-hot layout is not needed on a card with
atomics, so there is no tiled form here.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class DeviceCSR(NamedTuple):
    """A graph's CSR arrays on one device (uploaded once, then shared)."""

    row_ptr: torch.Tensor   # int64 (V+1,)
    src: torch.Tensor       # int32 (E,)  the COO expansion of row_ptr
    dst: torch.Tensor       # int32 (E,)
    weight: torch.Tensor    # float32 (E,)
    deg_w: torch.Tensor     # float32 (V,)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Weighted undirected graph in symmetric COO form, CSR-sorted by src."""

    num_vertices: int
    src: np.ndarray        # int32 (2*E_undirected,)  sorted ascending
    dst: np.ndarray        # int32 (2*E_undirected,)
    weight: np.ndarray     # float32 (2*E_undirected,)
    row_ptr: np.ndarray    # int64 (V+1,)  CSR offsets into src/dst/weight
    deg_w: np.ndarray      # float32 (V,)  weighted degree = sum of incident w
    # per-graph derived views (padded layouts, device uploads); never
    # compared, and dies with the graph
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def num_directed_entries(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_undirected_edges(self) -> int:
        return int(self.src.shape[0]) // 2

    @property
    def total_weight(self) -> float:
        """Sum of weighted degrees = 2 * (weighted undirected edge count).

        A float32 numpy sum, exactly as the reference computes it: the
        Eq. 5 capacity derives from it, so its rounding is part of the
        trajectory.
        """
        return float(self.deg_w.sum())

    def validate(self) -> None:
        """Raise ``ValueError`` unless the arrays form a symmetric CSR:
        equal lengths, ``row_ptr`` of V+1 non-decreasing offsets, ids in
        range, and the multiset of (dst, src) equal to that of (src, dst)."""
        if not self.src.shape == self.dst.shape == self.weight.shape:
            raise ValueError("src, dst and weight differ in shape")
        if self.row_ptr.shape != (self.num_vertices + 1,):
            raise ValueError(f"row_ptr has shape {self.row_ptr.shape}, "
                             f"expected ({self.num_vertices + 1},)")
        if np.any(np.diff(self.row_ptr) < 0):
            raise ValueError("row_ptr is not non-decreasing")
        if self.src.size and (self.src.min() < 0
                              or self.src.max() >= self.num_vertices):
            raise ValueError("src holds ids outside [0, num_vertices)")
        key_f = self.src.astype(np.int64) * self.num_vertices + self.dst
        key_b = self.dst.astype(np.int64) * self.num_vertices + self.src
        if not np.array_equal(np.sort(key_f), np.sort(key_b)):
            raise ValueError("not symmetric")

    def on_device(self, device) -> bool:
        """Whether ``to_device(device)`` has uploaded the arrays already."""
        return ("device", str(torch.device(device))) in self._cache

    def to_device(self, device) -> DeviceCSR:
        """The CSR arrays on ``device``, uploaded once and cached."""
        device = torch.device(device)
        key = ("device", str(device))
        csr = self._cache.get(key)
        if csr is None:
            csr = self._cache[key] = DeviceCSR(
                row_ptr=torch.from_numpy(
                    np.ascontiguousarray(self.row_ptr, np.int64)).to(device),
                src=torch.from_numpy(
                    np.ascontiguousarray(self.src, np.int32)).to(device),
                dst=torch.from_numpy(
                    np.ascontiguousarray(self.dst, np.int32)).to(device),
                weight=torch.from_numpy(
                    np.ascontiguousarray(self.weight, np.float32)).to(device),
                deg_w=torch.from_numpy(
                    np.ascontiguousarray(self.deg_w, np.float32)).to(device))
        return csr


def _dedupe(src: np.ndarray, dst: np.ndarray, num_vertices: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Remove self-loops and exact duplicate directed edges."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * num_vertices + dst.astype(np.int64)
    key = np.unique(key)
    return ((key // num_vertices).astype(np.int32),
            (key % num_vertices).astype(np.int32))


def from_edges(src, dst, num_vertices: int, directed: bool = True) -> Graph:
    """Build the weighted undirected Graph per Eq. (3).

    w(u,v) = 2 if both (u,v) and (v,u) exist in the directed input, else 1.
    Undirected input gets w = 1 everywhere.
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if src.size:
        assert int(max(src.max(), dst.max())) < num_vertices
    src, dst = _dedupe(src, dst, num_vertices)

    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    canon = lo * num_vertices + hi
    uniq, counts = np.unique(canon, return_counts=True)
    u = (uniq // num_vertices).astype(np.int32)
    v = (uniq % num_vertices).astype(np.int32)
    if directed:
        w = counts.astype(np.float32)          # 1 = one direction, 2 = both
    else:
        w = np.ones_like(counts, dtype=np.float32)

    sym_src = np.concatenate([u, v])
    sym_dst = np.concatenate([v, u])
    sym_w = np.concatenate([w, w])
    return _finish(sym_src, sym_dst, sym_w, num_vertices)


def _finish(src, dst, w, num_vertices: int) -> Graph:
    # (src, dst) order by one stable sort of the packed key: the same
    # permutation as np.lexsort((dst, src)), in less than half the time
    key = src.astype(np.int64) * num_vertices + dst
    order = np.argsort(key, kind="stable")
    src, dst, w = src[order], dst[order], w[order].astype(np.float32)
    counts = np.bincount(src, minlength=num_vertices).astype(np.int64)
    row_ptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    deg_w = np.zeros(num_vertices, dtype=np.float32)
    np.add.at(deg_w, src, w)
    return Graph(num_vertices=num_vertices, src=src.astype(np.int32),
                 dst=dst.astype(np.int32), weight=w, row_ptr=row_ptr,
                 deg_w=deg_w)


def add_edges(graph: Graph, new_src, new_dst, directed: bool = True,
              num_vertices: Optional[int] = None) -> Graph:
    """Incremental growth (Section 3.4): returns the extended graph.

    ``num_vertices`` may exceed the old count to inject new vertices.
    Weights are recomputed for touched pairs; untouched edges keep theirs.
    """
    V = max(num_vertices or 0, graph.num_vertices,
            int(np.max(new_src) + 1) if len(new_src) else 0,
            int(np.max(new_dst) + 1) if len(new_dst) else 0)
    # Reconstruct a directed view of the old graph: an undirected edge of
    # weight 2 stands for both directions, weight 1 for the canonical one.
    half = graph.src < graph.dst
    u, v, w = graph.src[half], graph.dst[half], graph.weight[half]
    both = w >= 2
    old_src = np.concatenate([u, v[both]])
    old_dst = np.concatenate([v, u[both]])
    src = np.concatenate([old_src, np.asarray(new_src, np.int32)])
    dst = np.concatenate([old_dst, np.asarray(new_dst, np.int32)])
    return from_edges(src, dst, V, directed=directed)


def remove_vertices(graph: Graph, vertices) -> Graph:
    """Drop vertices (keeping ids stable) and their incident edges."""
    drop = np.zeros(graph.num_vertices, dtype=bool)
    drop[np.asarray(vertices)] = True
    keep = ~(drop[graph.src] | drop[graph.dst])
    return _finish(graph.src[keep], graph.dst[keep], graph.weight[keep],
                   graph.num_vertices)


def shape_bucket(n: int, floor: int = 64) -> int:
    """Power-of-two-ish rounding for shape buckets.

    Returns the smallest value >= max(n, floor) of the form
    ``m * 2**(e-2)`` with mantissa m in {5, 6, 7, 8} (quarter steps
    between consecutive powers of two), so padding overhead is at most
    25% while graphs of similar size share one padded layout.
    """
    n = max(int(n), int(floor), 1)
    p = 1 << (n - 1).bit_length()          # smallest power of two >= n
    half = p // 2
    step = max(half // 4, 1)
    for m in range(1, 5):
        b = half + m * step                # half * {1.25, 1.5, 1.75, 2}
        if b >= n:
            return b
    return p


def pad_graph(graph: Graph, v_pad: int, e_pad: int) -> Graph:
    """Zero-padded view of ``graph`` with bucketed (V, E) shapes.

    Pad vertices are isolated (``deg_w`` 0); pad edge slots are weight-0
    self-loops spread over the pad vertex range (or parked on the last
    vertex when V is already at its bucket), so every score backend
    treats them as exact no-ops.  The engines mask pad vertices out of
    migration and halting aggregates with a ``valid`` mask.  The
    tie-break noise is drawn over the PADDED vertex set, so the
    trajectory depends on the bucket.
    """
    V, E = graph.num_vertices, graph.num_directed_entries
    if v_pad < V or e_pad < E:
        raise ValueError(f"pad shapes ({v_pad}, {e_pad}) below graph "
                         f"shapes ({V}, {E})")
    if v_pad == V and e_pad == E:
        return graph
    extra = e_pad - E
    if extra and v_pad > V:
        pad_src = np.sort((np.arange(extra, dtype=np.int64)
                           % (v_pad - V)).astype(np.int32) + V)
    else:
        pad_src = np.full(extra, v_pad - 1, np.int32)
    src = np.concatenate([graph.src, pad_src])
    dst = np.concatenate([graph.dst, pad_src])
    w = np.concatenate([graph.weight, np.zeros(extra, np.float32)])
    counts = np.bincount(src, minlength=v_pad).astype(np.int64)
    row_ptr = np.zeros(v_pad + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    deg_w = np.concatenate([graph.deg_w, np.zeros(v_pad - V, np.float32)])
    return Graph(num_vertices=v_pad, src=src, dst=dst, weight=w,
                 row_ptr=row_ptr, deg_w=deg_w)
