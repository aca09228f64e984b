"""Spinner core in PyTorch: graphs, metrics, the engine, ``partition``
and the continuous-partitioning session (``open_session``)."""
from . import delta, engine, generators, graph, metrics
from .engine import (EngineOptions, SpinnerState, make_frontier_runner,
                     make_fused_runner, run_chunked, run_frontier, run_fused,
                     run_sharded, run_sharded_frontier)
from .graph import (Graph, add_edges, from_edges, pad_graph,
                    remove_vertices, shape_bucket)
from .incremental import adapt, elastic_relabel, extend_labels, resize
from .metrics import partitioning_difference, phi, rho, summarize
from .session import PartitionSession, open_session
from .spinner import (PartitionResult, SpinnerConfig, compute_loads,
                      init_labels, partition, prepare_init)

__all__ = [
    "delta", "engine", "generators", "graph", "metrics",
    "EngineOptions", "SpinnerState", "make_frontier_runner",
    "make_fused_runner", "run_chunked", "run_frontier", "run_fused",
    "run_sharded", "run_sharded_frontier",
    "Graph", "add_edges", "from_edges", "pad_graph", "remove_vertices",
    "shape_bucket", "adapt", "elastic_relabel", "extend_labels", "resize",
    "partitioning_difference", "phi", "rho", "summarize",
    "PartitionSession", "open_session",
    "PartitionResult", "SpinnerConfig", "compute_loads", "init_labels",
    "partition", "prepare_init",
]
