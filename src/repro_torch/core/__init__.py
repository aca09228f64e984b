"""Spinner core in PyTorch: graphs, metrics, the engine and ``partition``."""
from . import engine, generators, graph, metrics
from .engine import (EngineOptions, SpinnerState, make_fused_runner,
                     run_chunked, run_fused)
from .graph import Graph, from_edges, pad_graph, shape_bucket
from .metrics import phi, rho, summarize
from .spinner import (PartitionResult, SpinnerConfig, compute_loads,
                      init_labels, partition, prepare_init)

__all__ = [
    "engine", "generators", "graph", "metrics",
    "EngineOptions", "SpinnerState", "make_fused_runner", "run_chunked",
    "run_fused", "Graph", "from_edges", "pad_graph", "shape_bucket",
    "phi", "rho", "summarize", "PartitionResult", "SpinnerConfig",
    "compute_loads", "init_labels", "partition", "prepare_init",
]
