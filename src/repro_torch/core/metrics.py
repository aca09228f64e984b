"""Partitioning quality metrics (Section 5.1, Eq. 13), in numpy.

phi  = ratio of local edges (fraction of edges whose endpoints share a label)
rho  = maximum normalized load (max partition load / ideal load)
score(G) = Eq. (9), the aggregate objective the vertices hill-climb.

Following Eq. (6), the load B(l) sums *weighted degrees* of the vertices in
l, so sum_l B(l) == total_weight; the ideal load is total_weight / k.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph


def loads(graph: Graph, labels: np.ndarray, k: int) -> np.ndarray:
    """B(l) per Eq. (6): weighted degree mass per partition."""
    labels = np.asarray(labels)
    out = np.zeros(k, dtype=np.float64)
    np.add.at(out, labels, graph.deg_w.astype(np.float64))
    return out


def phi(graph: Graph, labels: np.ndarray) -> float:
    """Unweighted ratio of local edges (paper's phi)."""
    labels = np.asarray(labels)
    local = labels[graph.src] == labels[graph.dst]
    return float(local.mean()) if local.size else 1.0


def phi_weighted(graph: Graph, labels: np.ndarray) -> float:
    """Weighted locality: fraction of message volume that stays local."""
    labels = np.asarray(labels)
    local = (labels[graph.src] == labels[graph.dst]).astype(np.float64)
    tw = graph.weight.astype(np.float64)
    return float((local * tw).sum() / tw.sum()) if tw.size else 1.0


def rho(graph: Graph, labels: np.ndarray, k: int) -> float:
    """Maximum normalized load (Eq. 13)."""
    b = loads(graph, labels, k)
    ideal = graph.total_weight / k
    return float(b.max() / ideal) if ideal > 0 else 1.0


def score_global(graph: Graph, labels: np.ndarray, k: int, c: float) -> float:
    """Eq. (9): sum over vertices of score''(v, alpha(v))."""
    labels = np.asarray(labels)
    local_w = np.zeros(graph.num_vertices, dtype=np.float64)
    same = labels[graph.src] == labels[graph.dst]
    np.add.at(local_w, graph.src[same], graph.weight[same].astype(np.float64))
    degw = np.maximum(graph.deg_w.astype(np.float64), 1e-12)
    norm = local_w / degw
    C = c * graph.total_weight / k
    pen = loads(graph, labels, k) / C
    return float((norm - pen[labels]).sum())


def partitioning_difference(labels_a: np.ndarray,
                            labels_b: np.ndarray) -> float:
    """Fraction of vertices whose partition differs (Section 5.4): how much
    an adapt moved."""
    a = np.asarray(labels_a)
    b = np.asarray(labels_b)
    if a.shape != b.shape:
        raise ValueError(f"label vectors differ in shape: {a.shape} vs "
                         f"{b.shape}")
    return float((a != b).mean()) if a.size else 0.0


def comm_volume(graph: Graph, labels: np.ndarray, k: int) -> np.ndarray:
    """Per-partition remote-neighbour count: entry ``l`` counts the
    directed adjacency entries whose source is in partition ``l`` and
    whose destination is not (the directed cut, split by source label)."""
    labels = np.asarray(labels)
    cut = labels[graph.src] != labels[graph.dst]
    return np.bincount(labels[graph.src[cut]], minlength=k).astype(np.int64)


def frontier_fraction(sg) -> float:
    """Fraction of a ``ShardedGraph``'s real edges in the frontier
    segment: the share of each step's scoring that must wait for the label
    exchange under the overlap schedule (``EngineOptions.overlap``)."""
    interior = int(np.sum(sg.interior_counts))
    frontier = int(np.sum(sg.frontier_counts))
    total = interior + frontier
    return float(frontier / total) if total else 0.0


def summarize(graph: Graph, labels: np.ndarray, k: int, c: float = 1.05,
              sg=None) -> dict:
    """Quality summary of one assignment; pass a ``ShardedGraph`` as
    ``sg`` to add the layout's ``frontier_fraction``."""
    cv = comm_volume(graph, labels, k)
    out = {
        "phi": phi(graph, labels),
        "phi_weighted": phi_weighted(graph, labels),
        "rho": rho(graph, labels, k),
        "score": score_global(graph, labels, k, c),
        "comm_volume": int(cv.sum()),
        "comm_volume_max": int(cv.max()) if cv.size else 0,
        "k": k,
    }
    if sg is not None:
        out["frontier_fraction"] = frontier_fraction(sg)
    return out
