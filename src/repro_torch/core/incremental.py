"""Incremental (Section 3.4) and elastic (Section 3.5) repartitioning.

Both reduce to: perturb the previous stable labeling, then restart the core
LPA -- "supporting incremental and elastic repartitioning is as simple as
halting the computation and restarting it" (Section 4.2).

Both entry points ride on ``spinner.partition`` (a throwaway
``PartitionSession``), so they run on the card unless ``device="cpu"`` is
passed through ``**kw``.  For a STREAM of adapts/resizes, hold a
``repro_torch.core.session.PartitionSession`` instead: its ``adapt()`` /
``resize()`` give the same results and keep the upload, the previous
labels and the on-device delta across calls.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .graph import Graph
from .spinner import PartitionResult, SpinnerConfig, partition


def extend_labels(prev_labels: np.ndarray, new_num_vertices: int) -> np.ndarray:
    """Carry labels to a grown vertex set; new vertices marked -1.

    ``partition`` assigns -1 entries to the least-loaded partition, matching
    Section 3.4 ("we assign them to the least loaded partition").  The
    vertex set may only GROW: ids are positional, so a smaller count cannot
    say which vertices went.  To remove vertices, rebuild the graph with
    ``graph.remove_vertices`` and re-index the previous labels first.
    """
    prev = np.asarray(prev_labels, dtype=np.int32)
    if new_num_vertices < prev.shape[0]:
        raise ValueError(
            f"extend_labels: new vertex count {new_num_vertices} is "
            f"smaller than the previous labeling ({prev.shape[0]} "
            "vertices); the incremental restart only supports a grown "
            "vertex set -- remove vertices via graph.remove_vertices and "
            "remap the previous labels through its survivor index first")
    out = np.full(new_num_vertices, -1, dtype=np.int32)
    out[: prev.shape[0]] = prev
    return out


def adapt(graph: Graph, prev_labels: np.ndarray, cfg: SpinnerConfig,
          **kw) -> PartitionResult:
    """Incremental LPA: restart from the previous stable state (Section 3.4).

    Keyword arguments (``engine=``, ``record_history=``, ``device=``, ...)
    go to ``partition``.  ``graph`` must have at least as many vertices as
    ``prev_labels`` (see ``extend_labels``).
    """
    init = extend_labels(prev_labels, graph.num_vertices)
    return partition(graph, cfg, init=init, **kw)


def elastic_relabel(prev_labels: np.ndarray, k_old: int, k_new: int,
                    seed: int = 0) -> np.ndarray:
    """Probabilistic relabeling for a changed partition count (Section 3.5).

    Growth (n = k_new - k_old > 0): every vertex migrates with probability
    p = n / (k_old + n) (Eq. 10) to a uniformly random *new* partition, so
    expected loads stay uniform across all k_new partitions.
    Shrink: vertices on removed partitions move to a uniformly random
    surviving partition; everyone else stays.
    """
    prev = np.asarray(prev_labels, dtype=np.int32)
    rng = np.random.default_rng(seed)
    if k_new == k_old:
        return prev.copy()
    if k_new > k_old:
        n = k_new - k_old
        p = n / (k_old + n)
        move = rng.random(prev.shape[0]) < p
        dest = rng.integers(k_old, k_new, size=prev.shape[0]).astype(np.int32)
        return np.where(move, dest, prev)
    # shrink: partitions [k_new, k_old) are removed
    evicted = prev >= k_new
    dest = rng.integers(0, k_new, size=prev.shape[0]).astype(np.int32)
    return np.where(evicted, dest, prev)


def resize(graph: Graph, prev_labels: np.ndarray, cfg_new: SpinnerConfig,
           k_old: int, seed: Optional[int] = None, **kw) -> Tuple[
               PartitionResult, np.ndarray]:
    """Elastic LPA: relabel per Eq. (10), then restart (Section 3.5).

    Returns (result, relabeled_init) so callers can measure the shuffle the
    relabeling itself caused.  Like ``adapt``, forwards ``engine=`` and
    friends to ``partition``.
    """
    init = elastic_relabel(prev_labels, k_old, cfg_new.k,
                           seed=cfg_new.seed if seed is None else seed)
    return partition(graph, cfg_new, init=init, **kw), init
