"""repro_torch.apps -- the partition-consuming application layer.

The paper's headline claim (Section 7) is that consuming Spinner
partitions instead of hash partitioning speeds Pregel applications up by
cutting cross-worker message traffic.  This package is the consumer
side, on one device so far:

  * :mod:`repro_torch.apps.layout` places vertices by ANY label vector
    (Spinner's, or the hash baseline) and builds the placed CSR on the
    run's device;
  * :mod:`repro_torch.apps.workloads` defines the suite -- PageRank,
    connected components (WCC), BFS/SSSP -- with the semantics of
    ``core.pregel``'s numpy oracles;
  * :mod:`repro_torch.apps.engine` runs each superstep through the
    hand-written combine kernels (``kernels.pregel_combine``).

Entry point::

    from repro_torch.apps import run_app
    res = run_app(graph, labels, "pagerank")              # on the card
    res = run_app(graph, labels, "wcc", device="cpu")     # on the CPU
"""
from .engine import AppResult, AppState, run_app
from .layout import AppLayout, build_app_layout, placement_from_labels
from .workloads import (APPS, AppSpec, finalize_values, init_active,
                        init_values)

__all__ = [
    "APPS", "AppLayout", "AppResult", "AppSpec", "AppState",
    "build_app_layout", "finalize_values", "init_active", "init_values",
    "placement_from_labels", "run_app",
]
