"""Spinner-driven placement inside the LM framework (beyond the paper).

Two framework placement problems are graph partitioning in disguise; both
reuse the same LPA:

1.  **MoE expert placement** (``place_experts``): experts co-activated by
    the same token (top-k routing) exchange all-to-all traffic when they
    live on different EP shards.  The expert co-activation graph (edge
    weight = how often two experts fire for the same token) is partitioned
    into ``n_shards`` balanced parts: an expert -> shard map that cuts
    cross-shard co-activation mass while keeping the shards balanced.
2.  **Pipeline stage assignment** (``place_pipeline_stages``): the layer
    chain partitioned into S balanced stages.

Both return the partition plus before/after traffic metrics.  The
partitioning runs on the CUDA card unless ``device="cpu"`` asks for the
CPU; the graphs and metrics are numpy, and the labels and stats equal the
reference's (``repro.core.placement``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import metrics
from .engine import EngineOptions
from .graph import Graph, _finish, from_edges
from .session import PartitionSession
from .spinner import SpinnerConfig, partition


def coactivation_graph(choices: np.ndarray, n_experts: int,
                       max_edges: int = 2_000_000) -> Graph:
    """``choices``: (T, top_k) int expert ids per token -> the weighted
    expert graph.  Edge weight = the number of tokens that co-activate the
    pair (above ``max_edges`` pairs, a seeded sample)."""
    t, k = choices.shape
    pairs = []
    for i in range(k):
        for j in range(i + 1, k):
            pairs.append(np.stack([choices[:, i], choices[:, j]], axis=1))
    e = np.concatenate(pairs, axis=0)
    e = e[e[:, 0] != e[:, 1]]
    if e.shape[0] > max_edges:
        idx = np.random.default_rng(0).choice(e.shape[0], max_edges,
                                              replace=False)
        e = e[idx]
    # multiplicity becomes the edge WEIGHT (co-activation count)
    lo = np.minimum(e[:, 0], e[:, 1]).astype(np.int64)
    hi = np.maximum(e[:, 0], e[:, 1]).astype(np.int64)
    uniq, counts = np.unique(lo * n_experts + hi, return_counts=True)
    u = (uniq // n_experts).astype(np.int32)
    v = (uniq % n_experts).astype(np.int32)
    w = counts.astype(np.float32)
    return _finish(np.concatenate([u, v]), np.concatenate([v, u]),
                   np.concatenate([w, w]), n_experts)


def cross_shard_mass(choices: np.ndarray, assignment: np.ndarray) -> float:
    """Fraction of co-activated expert pairs split across shards."""
    t, k = choices.shape
    shards = assignment[choices]              # (T, k)
    total, cross = 0, 0
    for i in range(k):
        for j in range(i + 1, k):
            neq = shards[:, i] != shards[:, j]
            valid = choices[:, i] != choices[:, j]
            total += int(valid.sum())
            cross += int((neq & valid).sum())
    return cross / max(1, total)


# Incremental re-placement sessions, one per (n_experts, n_shards, seed,
# device): routing drift produces a stream of co-activation graphs of the
# same expert count, so successive place_experts(prev=...) calls reuse one
# session.  FIFO-bounded so seed/shard sweeps cannot hold graphs forever.
_PLACEMENT_SESSIONS: dict = {}
_PLACEMENT_SESSIONS_MAX = 8


def _placement_session(key, graph: Graph, cfg: SpinnerConfig,
                       device) -> PartitionSession:
    sess = _PLACEMENT_SESSIONS.get(key)
    if sess is None:
        while len(_PLACEMENT_SESSIONS) >= _PLACEMENT_SESSIONS_MAX:
            _PLACEMENT_SESSIONS.pop(
                next(iter(_PLACEMENT_SESSIONS))).close()
        sess = _PLACEMENT_SESSIONS[key] = PartitionSession(
            graph, cfg, EngineOptions(device=device))
    return sess


def place_experts(choices: np.ndarray, n_experts: int, n_shards: int,
                  seed: int = 0, prev: Optional[np.ndarray] = None,
                  graph: Optional[Graph] = None, device=None
                  ) -> Tuple[np.ndarray, dict]:
    """Partition experts across EP shards from router statistics.

    ``prev`` enables incremental re-placement as routing drifts (Section
    3.4 applied to the serving plane); those calls ride a reused
    ``PartitionSession``.  ``graph`` accepts a precomputed co-activation
    graph (``coactivation_graph(choices, n_experts)``).  Runs on the card
    unless ``device="cpu"``.
    """
    g = coactivation_graph(choices, n_experts) if graph is None else graph
    cfg = SpinnerConfig(k=n_shards, seed=seed, max_iters=150)
    if prev is None:
        res = partition(g, cfg, record_history=False, device=device)
    else:
        key = (n_experts, n_shards, seed,
               None if device is None else str(device))
        sess = _placement_session(key, g, cfg, device)
        res = sess.adapt(g, prev=np.asarray(prev, np.int32),
                         record_history=False)
    contiguous = (np.arange(n_experts) * n_shards // n_experts
                  ).astype(np.int32)
    stats = {
        "cross_before": cross_shard_mass(choices, contiguous),
        "cross_after": cross_shard_mass(choices, res.labels),
        "rho": metrics.rho(g, res.labels, n_shards),
        "iterations": res.iterations,
        "moved_from_prev": (None if prev is None else
                            metrics.partitioning_difference(prev, res.labels)),
    }
    stats["traffic_reduction"] = 1.0 - (
        stats["cross_after"] / max(1e-9, stats["cross_before"]))
    return res.labels, stats


def expert_placement_case(n_experts: int = 256, n_tokens: int = 20_000,
                          top_k: int = 2, n_shards: int = 8, seed: int = 0,
                          device=None) -> Tuple[Graph, np.ndarray, dict]:
    """``(graph, labels, stats)``: a ready-made MoE expert-placement case.

    Synthesizes clustered router statistics (experts fall into latent
    groups that tokens co-activate within), builds the co-activation graph
    once and places it; ``repro_torch.apps.run_app(graph, labels, ...)``
    against the same call with hash labels is the expert graph's
    hash-vs-Spinner comparison.
    """
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, n_shards, n_experts)
    tok_grp = rng.integers(0, n_shards, n_tokens)
    choices = np.empty((n_tokens, top_k), np.int64)
    for i in range(top_k):
        # 95% of picks stay inside the token's latent group
        in_grp = rng.random(n_tokens) < 0.95
        pick = rng.integers(0, n_experts, n_tokens)
        same = groups[pick] == tok_grp
        retry = pick.copy()
        for _ in range(8):      # rejection-sample toward the group
            bad = in_grp & ~same
            if not bad.any():
                break
            retry[bad] = rng.integers(0, n_experts, int(bad.sum()))
            same = groups[retry] == tok_grp
            pick = retry
        choices[:, i] = pick
    g = coactivation_graph(choices, n_experts)
    labels, stats = place_experts(choices, n_experts, n_shards, seed=seed,
                                  graph=g, device=device)
    return g, labels, stats


def place_pipeline_stages(layer_costs: np.ndarray, n_stages: int,
                          seed: int = 0, device=None
                          ) -> Tuple[np.ndarray, dict]:
    """Balanced partitioning of the layer chain into stages.

    The chain L0-L1-...-Ln is partitioned as a plain graph (edge
    multiplicity does not survive ``from_edges``: duplicates collapse per
    Eq. 3), and the result's per-stage cost balance is reported beside
    the contiguous split's.  Runs on the card unless ``device="cpu"``.
    """
    n = layer_costs.shape[0]
    src = np.arange(n - 1, dtype=np.int32)
    dst = src + 1
    g = from_edges(src, dst, n, directed=False)
    cfg = SpinnerConfig(k=n_stages, seed=seed, max_iters=200, c=1.10)
    res = partition(g, cfg, record_history=False, device=device)
    stage_cost = np.zeros(n_stages)
    np.add.at(stage_cost, res.labels, layer_costs)
    contiguous = (np.arange(n) * n_stages // n).astype(np.int32)
    cont_cost = np.zeros(n_stages)
    np.add.at(cont_cost, contiguous, layer_costs)
    cut = int((res.labels[src] != res.labels[dst]).sum())
    stats = {
        "stage_cost_max_over_mean":
            float(stage_cost.max() / max(stage_cost.mean(), 1e-9)),
        "contiguous_max_over_mean":
            float(cont_cost.max() / max(cont_cost.mean(), 1e-9)),
        "cut_edges": cut,
        "min_possible_cuts": n_stages - 1,
    }
    return res.labels, stats
