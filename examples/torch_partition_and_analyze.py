"""End-to-end on the PyTorch port: partition -> run graph analytics ->
measure the win (the port of ``examples/partition_and_analyze.py``).

Reproduces the mechanism of the paper's Section 5.6 (Figure 8 / Table 4):
the same PageRank/SSSP/WCC computation over hash- and Spinner-partitioned
layouts, with per-partition load and cross-partition message accounting.

    PYTHONPATH=src python examples/torch_partition_and_analyze.py
    PYTHONPATH=src python examples/torch_partition_and_analyze.py --device cpu

``--n`` sets the vertex count (default 30,000, the reference example's).
"""
import argparse

import numpy as np

from repro_torch.core import (SpinnerConfig, adapt, add_edges, generators,
                              metrics, partition, pregel)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--n", type=int, default=30_000)
    a = ap.parse_args(argv)

    k = 32
    graph = generators.powerlaw_ba(a.n, 8, seed=2)  # hub-heavy, Twitter-like
    print(f"graph: {graph.num_vertices} vertices, "
          f"{graph.num_undirected_edges} edges (power-law)")

    res = partition(graph, SpinnerConfig(k=k, seed=0), record_history=False,
                    engine="fused", device=a.device)
    hash_labels = (np.arange(graph.num_vertices) * 2654435761 % k
                   ).astype(np.int32)

    for app in ("pagerank", "sssp", "wcc"):
        kw = {"iters": 10} if app == "pagerank" else {}
        cmp = pregel.compare_partitionings(graph, k, hash_labels, res.labels,
                                           app, **kw)
        print(f"{app:9s} speedup={cmp['speedup_b_over_a']:.2f}x  "
              f"remote messages: {cmp['remote_msgs_a']:,} -> "
              f"{cmp['remote_msgs_b']:,} (-{cmp['msg_reduction']:.0%})")

    # incremental adaptation: the graph grows, the partitioning follows
    rng = np.random.default_rng(0)
    m = int(0.01 * graph.num_undirected_edges)
    grown = add_edges(graph, rng.integers(0, graph.num_vertices, m),
                      rng.integers(0, graph.num_vertices, m))
    res2 = adapt(grown, res.labels, SpinnerConfig(k=k, seed=0),
                 record_history=False, engine="fused", device=a.device)
    moved = metrics.partitioning_difference(res.labels, res2.labels)
    print(f"\n+1% edges: adapted in {res2.iterations} iterations, "
          f"moved {moved:.1%} of vertices "
          f"(phi={metrics.phi(grown, res2.labels):.3f})")


if __name__ == "__main__":
    main()
