"""Quickstart on the PyTorch port: partition a graph with Spinner and
inspect quality (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

``--n`` sets the vertex count (default 20,000, the reference example's).
"""
import argparse

import numpy as np

from repro_torch.core import (EngineOptions, SpinnerConfig, add_edges,
                              generators, metrics, open_session, partition)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--n", type=int, default=20_000)
    a = ap.parse_args(argv)

    # a small-world graph (the paper's synthetic workload family)
    graph = generators.watts_strogatz(n=a.n, k_nbrs=20, beta=0.3, seed=1)
    print(f"graph: {graph.num_vertices} vertices, "
          f"{graph.num_undirected_edges} edges")

    # paper defaults: c = 1.05, eps = 1e-3, w = 5  (Section 5.1)
    cfg = SpinnerConfig(k=16, c=1.05, eps=1e-3, halt_window=5, seed=0)
    # engine="chunked" records the per-iteration history on the device;
    # partition(graph, cfg, record_history=False) lets engine="auto" pick
    # "fused" (one host sync a chunk, no history)
    result = partition(graph, cfg, engine="chunked", device=a.device)

    phi = metrics.phi(graph, result.labels)
    rho = metrics.rho(graph, result.labels, cfg.k)
    hash_phi = metrics.phi(graph, np.arange(graph.num_vertices) % cfg.k)
    print(f"converged in {result.iterations} iterations "
          f"(halting criterion: eps={cfg.eps}, w={cfg.halt_window})")
    print(f"locality  phi = {phi:.3f}   (hash partitioning: {hash_phi:.3f}, "
          f"{phi / hash_phi:.1f}x better)")
    print(f"balance   rho = {rho:.3f}   (capacity bound c = {cfg.c})")
    print("per-iteration trace (first 5):")
    for h in result.history[:5]:
        print(f"  iter {h['iteration']:3d}  phi={h['phi']:.3f} "
              f"rho={h['rho']:.3f} migrations={h['migrations']}")

    # --- continuous partitioning: the session API (Sections 3.4-3.5) ------
    # A long-lived service holds a PartitionSession: the graph upload lives
    # on the device, and adapt()/resize() are cheap repeat calls -- a grown
    # graph inside its (V, E) shape bucket reuses the padded layout.
    rng = np.random.default_rng(0)
    opts = EngineOptions(device=a.device)
    with open_session(graph, cfg, opts) as session:
        base = session.partition(record_history=False)
        grown = add_edges(graph, rng.integers(0, graph.num_vertices, 500),
                          rng.integers(0, graph.num_vertices, 500))
        adapted = session.adapt(grown, record_history=False)
        resized = session.resize(cfg.k + 4, record_history=False)
        st = session.stats()
        moved = metrics.partitioning_difference(base.labels, adapted.labels)
        print(f"session: bucket={st['bucket']} runs={st['runs']} "
              f"uploads={st['uploads']}")
        print(f"adapt after 500 new edges: {adapted.iterations} iterations, "
              f"{moved:.1%} of vertices moved (vs ~{1 - 1 / cfg.k:.0%} from "
              f"scratch)")
        print(f"resize {cfg.k} -> {cfg.k + 4}: rho = "
              f"{metrics.rho(grown, resized.labels, cfg.k + 4):.3f}")


if __name__ == "__main__":
    main()
