"""repro_torch.apps -- the partition-consuming application layer.

The paper's headline claim (Section 7) is that consuming Spinner
partitions instead of hash partitioning speeds Pregel applications up by
cutting cross-worker message traffic.  This package is the consumer
side, on one device or SPMD over a mesh:

  * :mod:`repro_torch.apps.layout` places vertices on ``ndev`` devices by
    ANY label vector (Spinner's, or the hash baseline), builds the placed
    CSR on the run's device and gives each rank its interior and frontier
    CSRs;
  * :mod:`repro_torch.apps.workloads` defines the suite -- PageRank,
    connected components (WCC), BFS/SSSP -- with the semantics of
    ``core.pregel``'s numpy oracles;
  * :mod:`repro_torch.apps.engine` runs each superstep through the
    exchange plans of ``core.comm`` (on a mesh), the overlap schedule and
    the hand-written combine kernels (``kernels.pregel_combine``).

Entry points::

    from repro_torch.apps import run_app
    res = run_app(graph, labels, "pagerank")              # on the card
    res = run_app(graph, labels, "wcc", device="cpu")     # on the CPU
    # SPMD, one process per card, each in the same process group:
    res = run_app(graph, labels, "pagerank",
                  mesh=make_partition_mesh(), plan="halo")

or ``PartitionSession.run_app(workload)`` to consume the labels a session
just computed (on the session's mesh, if it has one).
"""
from .engine import AppResult, AppState, run_app
from .layout import (AppLayout, AppShard, build_app_layout,
                     placement_from_labels)
from .workloads import (APPS, AppSpec, finalize_values, init_active,
                        init_values)

__all__ = [
    "APPS", "AppLayout", "AppResult", "AppShard", "AppSpec", "AppState",
    "build_app_layout", "finalize_values", "init_active", "init_values",
    "placement_from_labels", "run_app",
]
