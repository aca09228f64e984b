"""Mini-Pregel: vectorized vertex programs with partition-aware accounting.

Reproduces the mechanism behind the paper's application experiments
(Figure 8 / Table 4), as the JAX package's ``core/pregel.py`` does (this
is its numpy copy): a synchronous engine where, per superstep,
  * every active vertex sends a value along its out-edges,
  * per-partition compute load = messages processed by that partition,
  * network traffic = messages whose endpoints live in different
    partitions.
The simulated superstep time is  max_p(compute_p) * t_msg  +
remote_msgs * t_net  -- the straggler-at-the-barrier model the paper's
Table 4 measures (unbalance -> idling; cut edges -> network).

Three canonical programs: PageRank, SSSP (BFS on unit weights), WCC.
All are pure numpy: these are the ORACLES the device application engine
(:mod:`repro_torch.apps`) is tested against.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .graph import Graph


@dataclasses.dataclass
class SuperstepStats:
    messages: int
    remote_messages: int
    per_partition_msgs: np.ndarray      # (k,) messages processed (by dst)

    def simulated_time(self, t_msg: float = 1.0, t_net: float = 4.0,
                       k: Optional[int] = None) -> float:
        return float(self.per_partition_msgs.max() * t_msg
                     + self.remote_messages * t_net
                     / max(1, len(self.per_partition_msgs)))


@dataclasses.dataclass
class PregelResult:
    values: np.ndarray
    supersteps: int
    stats: List[SuperstepStats]

    def total_messages(self) -> int:
        return sum(s.messages for s in self.stats)

    def total_remote(self) -> int:
        return sum(s.remote_messages for s in self.stats)

    def simulated_runtime(self, **kw) -> float:
        return sum(s.simulated_time(**kw) for s in self.stats)


def _stats(graph: Graph, labels: np.ndarray, k: int, active: np.ndarray
           ) -> SuperstepStats:
    src_active = active[graph.src]
    msgs = int(src_active.sum())
    remote = labels[graph.src] != labels[graph.dst]
    remote_msgs = int((src_active & remote).sum())
    per_part = np.bincount(labels[graph.dst[src_active]], minlength=k
                           ).astype(np.int64)
    return SuperstepStats(messages=msgs, remote_messages=remote_msgs,
                          per_partition_msgs=per_part)


def pagerank(graph: Graph, labels: np.ndarray, k: int, iters: int = 20,
             damping: float = 0.85) -> PregelResult:
    V = graph.num_vertices
    out_deg = np.bincount(graph.src, minlength=V).astype(np.float64)
    pr = np.full(V, 1.0 / V)
    stats = []
    active = np.ones(V, bool)
    for _ in range(iters):
        contrib = np.zeros(V)
        share = pr / np.maximum(out_deg, 1.0)
        np.add.at(contrib, graph.dst, share[graph.src])
        pr = (1 - damping) / V + damping * contrib
        stats.append(_stats(graph, labels, k, active))
    return PregelResult(values=pr, supersteps=iters, stats=stats)


def sssp(graph: Graph, source: int, labels: np.ndarray, k: int,
         max_steps: int = 10_000) -> PregelResult:
    V = graph.num_vertices
    dist = np.full(V, np.inf)
    dist[source] = 0.0
    active = np.zeros(V, bool)
    active[source] = True
    stats = []
    steps = 0
    while active.any() and steps < max_steps:
        stats.append(_stats(graph, labels, k, active))
        cand = np.full(V, np.inf)
        live = active[graph.src]
        np.minimum.at(cand, graph.dst[live], dist[graph.src[live]] + 1.0)
        improved = cand < dist
        dist = np.where(improved, cand, dist)
        active = improved
        steps += 1
    return PregelResult(values=dist, supersteps=steps, stats=stats)


def wcc(graph: Graph, labels: np.ndarray, k: int, max_steps: int = 10_000
        ) -> PregelResult:
    V = graph.num_vertices
    comp = np.arange(V, dtype=np.int64)
    active = np.ones(V, bool)
    stats = []
    steps = 0
    while active.any() and steps < max_steps:
        stats.append(_stats(graph, labels, k, active))
        cand = comp.copy()
        live = active[graph.src]
        np.minimum.at(cand, graph.dst[live], comp[graph.src[live]])
        improved = cand < comp
        comp = np.where(improved, cand, comp)
        active = improved
        steps += 1
    return PregelResult(values=comp, supersteps=steps, stats=stats)


def compare_partitionings(graph: Graph, k: int, labels_a: np.ndarray,
                          labels_b: np.ndarray, app: str = "pagerank",
                          **kw) -> dict:
    """Run one app under two partitionings; report the Fig.8-style ratio."""
    fn = {"pagerank": lambda lab: pagerank(graph, lab, k, **kw),
          "sssp": lambda lab: sssp(graph, 0, lab, k, **kw),
          "wcc": lambda lab: wcc(graph, lab, k, **kw)}[app]
    ra, rb = fn(labels_a), fn(labels_b)
    assert np.allclose(np.nan_to_num(ra.values, posinf=1e18),
                       np.nan_to_num(rb.values, posinf=1e18)), \
        "partitioning must not change results"
    return {
        "app": app,
        "remote_msgs_a": ra.total_remote(),
        "remote_msgs_b": rb.total_remote(),
        "sim_time_a": ra.simulated_runtime(),
        "sim_time_b": rb.simulated_runtime(),
        "speedup_b_over_a": ra.simulated_runtime() / rb.simulated_runtime(),
        "msg_reduction": 1.0 - rb.total_remote() / max(1, ra.total_remote()),
    }
