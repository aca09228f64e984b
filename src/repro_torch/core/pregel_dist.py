"""Distributed PageRank over a label placement -- a thin wrapper.

The integration the paper performs on Giraph (Section 5.6), on a
``torch.distributed`` mesh: vertices are placed by partition label and
each superstep exchanges only the boundary values other devices
reference, so a better partitioning (Spinner vs hash) shrinks the bytes
on the wire -- the mechanism behind the paper's 2x application speedup.
The run is :func:`repro_torch.apps.run_app` with the halo plan; this
module keeps the ``(values, stats)`` entry with the measured wire bytes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def pagerank_distributed(graph, labels: np.ndarray, mesh,
                         iters: int = 20, damping: float = 0.85,
                         axis: str = "data",
                         plan: Optional[str] = None
                         ) -> Tuple[np.ndarray, dict]:
    """PageRank on ``graph`` placed by ``labels`` over ``mesh`` (SPMD: call
    it on every rank).

    ``stats`` keeps the historical ``halo_true_bytes_per_step`` key, the
    device-accumulated per-superstep wire bytes of the plan (default
    halo; 0 on a one-device mesh: nothing crosses the wire).
    """
    from ..apps import build_app_layout, run_app
    from ..launch.mesh import mesh_device

    res = run_app(graph, labels, "pagerank", mesh=mesh, axis=axis,
                  plan=plan or "halo", iters=iters, damping=damping)
    layout = build_app_layout(graph, np.asarray(labels), mesh_device(mesh),
                              ndev=res.ndev)
    stats = {
        "halo_true_bytes_per_step": res.wire_bytes_per_step,
        "wire_bytes": res.wire_bytes,
        "supersteps": res.supersteps,
        "straggler_skew": res.straggler_skew,
        "v_per_dev": layout.v_per_dev,
        "iters": iters,
    }
    return res.values, stats
