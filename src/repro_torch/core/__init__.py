"""Spinner core in PyTorch: graphs, metrics, the engine, ``partition``
and the continuous-partitioning session (``open_session``).

The reference's TPU-only names are not here: the Pallas tile layout
(``TiledCSR``, ``build_tiled_csr``) and the jit / ``shard_map`` plumbing
(``make_chunked_runner``, ``make_step_fn``, ``make_iteration``); see the
README."""
from . import (comm, delta, engine, generators, graph, incremental, metrics,
               session)
from .delta import (DeltaTracker, DeviceDelta, apply_delta,
                    check_edge_updates, coalesce_updates)
from .engine import (EngineOptions, SpinnerState, batch_signature,
                     make_frontier_runner, make_fused_runner,
                     make_sharded_runner, make_vertex_update, run_batched,
                     run_chunked, run_frontier, run_fused, run_sharded,
                     run_sharded_frontier)
from .graph import (Graph, add_edges, from_edges, pad_graph,
                    remove_vertices, shape_bucket)
from .incremental import adapt, elastic_relabel, extend_labels, resize
from .metrics import (comm_volume, frontier_fraction,
                      partitioning_difference, phi, phi_weighted, rho,
                      score_global, summarize)
from .session import PartitionSession, open_session
from .spinner import (PartitionResult, SpinnerConfig,
                      SpinnerDeprecationWarning, compute_loads, init_labels,
                      make_step, partition, prepare_init, resolve_options)

__all__ = [
    "Graph", "from_edges", "add_edges", "pad_graph", "remove_vertices",
    "shape_bucket",
    "SpinnerConfig", "SpinnerDeprecationWarning", "EngineOptions",
    "PartitionResult", "PartitionSession", "open_session", "SpinnerState",
    "DeltaTracker", "DeviceDelta", "apply_delta", "check_edge_updates",
    "coalesce_updates", "run_batched", "batch_signature",
    "partition", "prepare_init", "resolve_options", "make_step",
    "make_vertex_update", "make_fused_runner", "make_frontier_runner",
    "make_sharded_runner",
    "run_fused", "run_chunked", "run_sharded", "run_frontier",
    "run_sharded_frontier", "init_labels",
    "compute_loads", "adapt", "resize", "elastic_relabel", "extend_labels",
    "phi", "phi_weighted", "rho", "score_global", "comm_volume",
    "frontier_fraction",
    "partitioning_difference", "summarize", "comm", "delta", "engine",
    "generators", "graph", "metrics", "incremental", "session",
]
