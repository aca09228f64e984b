"""Seeded synthetic graph generators (numpy).

Watts-Strogatz small worlds are the paper's scalability workload (Section
5.2); preferential-attachment power-law graphs give hub structure; the
planted-partition graph has known communities; the 2-D grid is an oracle
whose good cuts are known; Erdos-Renyi graphs have no structure at all.
Same seeds, same graphs as the reference package.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph, from_edges


def watts_strogatz(n: int, k_nbrs: int, beta: float, seed: int = 0) -> Graph:
    """Ring lattice with ``k_nbrs`` out-edges per vertex, ``beta`` rewired.

    Directed ring lattice with a fraction beta of edge targets rewired
    uniformly at random (Section 5.2).
    """
    assert k_nbrs < n
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n, dtype=np.int64), k_nbrs)
    offs = np.tile(np.arange(1, k_nbrs + 1, dtype=np.int64), n)
    dst = (src + offs) % n
    rewire = rng.random(src.shape[0]) < beta
    dst[rewire] = rng.integers(0, n, size=int(rewire.sum()))
    # avoid self loops from rewiring
    self_loop = dst == src
    dst[self_loop] = (dst[self_loop] + 1) % n
    return from_edges(src.astype(np.int32), dst.astype(np.int32), n,
                      directed=True)


def powerlaw_ba(n: int, m: int, seed: int = 0) -> Graph:
    """Barabasi-Albert preferential attachment: power-law degrees (hubs).

    New vertex t attaches m edges to targets sampled from the
    degree-proportional pool.
    """
    rng = np.random.default_rng(seed)
    assert n > m >= 1
    core_src, core_dst = [], []
    for i in range(m + 1):
        for j in range(i + 1, m + 1):
            core_src.append(i)
            core_dst.append(j)
    src_list = [np.array(core_src, dtype=np.int64)]
    dst_list = [np.array(core_dst, dtype=np.int64)]
    pool = np.repeat(np.arange(m + 1), m).astype(np.int64)
    for t in range(m + 1, n):
        samples = pool[rng.integers(0, pool.shape[0], size=3 * m)]
        # first-occurrence unique (np.unique would sort and bias toward
        # low ids, creating unboundedly rich hubs)
        _, first = np.unique(samples, return_index=True)
        targets = samples[np.sort(first)][:m]
        if targets.shape[0] < m:
            extra = rng.integers(0, t, size=m - targets.shape[0])
            targets = np.unique(np.concatenate([targets, extra]))
        src_list.append(np.full(targets.shape[0], t, dtype=np.int64))
        dst_list.append(targets)
        pool = np.concatenate([pool, targets,
                               np.full(targets.shape[0], t, dtype=np.int64)])
    src = np.concatenate(src_list)
    dst = np.concatenate(dst_list)
    return from_edges(src.astype(np.int32), dst.astype(np.int32), n,
                      directed=False)


def grid_2d(rows: int, cols: int) -> Graph:
    """4-connected grid; the partitioning oracle (good cuts are known)."""
    idx = np.arange(rows * cols, dtype=np.int64).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])
    src = np.concatenate([right[0], down[0]])
    dst = np.concatenate([right[1], down[1]])
    return from_edges(src.astype(np.int32), dst.astype(np.int32),
                      rows * cols, directed=False)


def erdos_renyi(n: int, avg_deg: float, seed: int = 0) -> Graph:
    """G(n, m) with m = n * avg_deg / 2 uniform undirected pairs."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return from_edges(src.astype(np.int32), dst.astype(np.int32), n,
                      directed=False)


def clustered_graph(num_clusters: int, cluster_size: int, p_in: float,
                    p_out_edges_per_v: float, seed: int = 0) -> Graph:
    """Planted-partition graph: ground-truth communities for quality tests."""
    rng = np.random.default_rng(seed)
    n = num_clusters * cluster_size
    srcs, dsts = [], []
    for c in range(num_clusters):
        base = c * cluster_size
        m_in = int(p_in * cluster_size * cluster_size / 2)
        s = rng.integers(0, cluster_size, size=m_in) + base
        d = rng.integers(0, cluster_size, size=m_in) + base
        srcs.append(s)
        dsts.append(d)
    m_out = int(p_out_edges_per_v * n)
    srcs.append(rng.integers(0, n, size=m_out))
    dsts.append(rng.integers(0, n, size=m_out))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    return from_edges(src.astype(np.int32), dst.astype(np.int32), n,
                      directed=False)
