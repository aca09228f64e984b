"""Elastic repartitioning on the PyTorch port (Section 3.5): scale a running
partitioning 16 -> 20 -> 12 partitions without recomputing from scratch,
as a cluster does when nodes join or are preempted (the port of
``examples/elastic_resize.py``).

    PYTHONPATH=src python examples/torch_elastic_resize.py
    PYTHONPATH=src python examples/torch_elastic_resize.py --device cpu

``--n`` sets the vertex count (default 30,000, the reference example's).
"""
import argparse

from repro_torch.core import (SpinnerConfig, generators, metrics, partition,
                              resize)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--n", type=int, default=30_000)
    a = ap.parse_args(argv)

    graph = generators.watts_strogatz(a.n, 16, 0.3, seed=4)
    print(f"graph: {graph.num_vertices} vertices, "
          f"{graph.num_undirected_edges} edges\n")

    k = 16
    # the fused runner: one host sync a chunk for the whole run (and for
    # every elastic restart below)
    res = partition(graph, SpinnerConfig(k=k, seed=0), record_history=False,
                    engine="fused", device=a.device)
    print(f"initial k={k}: phi={metrics.phi(graph, res.labels):.3f} "
          f"rho={metrics.rho(graph, res.labels, k):.3f} "
          f"({res.iterations} iters)")

    for k_new, event in ((20, "4 nodes join"), (12, "8 nodes preempted")):
        cfg = SpinnerConfig(k=k_new, seed=1)
        res_new, _ = resize(graph, res.labels, cfg, k_old=k,
                            record_history=False, engine="fused",
                            device=a.device)
        moved = metrics.partitioning_difference(res.labels, res_new.labels)
        print(f"{event}: k={k} -> {k_new}  "
              f"adapted in {res_new.iterations} iters, moved {moved:.1%}  "
              f"phi={metrics.phi(graph, res_new.labels):.3f} "
              f"rho={metrics.rho(graph, res_new.labels, k_new):.3f}")
        res, k = res_new, k_new


if __name__ == "__main__":
    main()
