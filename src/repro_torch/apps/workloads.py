"""The partition-consuming workload suite (paper Section 7 / Figure 8).

Each workload is a Pregel vertex program over a combine MONOID:

  * the message a vertex sends along its out-edges (PageRank:
    ``pr / out_degree``; min-propagation: the value itself, plus
    ``bias``);
  * ``combine`` -- how incoming messages fold (``sum`` / ``min``);
  * the update -- the new vertex value from the combined inbox
    (PageRank's damped affine map; the monotone ``min(old, acc)``).

Semantics follow ``core.pregel``'s numpy oracles: messages are
UNWEIGHTED (the Eq. 3 edge weights only shape the partitioner), the
PageRank share divisor is the directed-entry out-degree, WCC components
converge to the minimum ORIGINAL vertex id (so results are
placement-invariant by construction), and BFS/SSSP counts unit hops.

``init_values`` / ``init_active`` give the PERMUTED padded initial state
for an :class:`repro_torch.apps.layout.AppLayout`; pad vertices carry the
monoid-neutral value and are never active.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..kernels.ref import INF_I32


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """Static description of one vertex program."""
    name: str
    combine: str            # "sum" (float32) | "min" (int32)
    bias: int               # added to each message (BFS hop count)
    halts: bool             # drain-halt on zero changed vs. fixed iters
    default_iters: int      # pagerank sweep length / halt-cap for others


APPS = {
    "pagerank": AppSpec("pagerank", "sum", 0, False, 20),
    "wcc": AppSpec("wcc", "min", 0, True, 4096),
    "bfs": AppSpec("bfs", "min", 1, True, 4096),
}
APPS["sssp"] = dataclasses.replace(APPS["bfs"], name="sssp")


def init_values(spec: AppSpec, layout, source: int = 0) -> np.ndarray:
    """(v_pad,) initial values in PERMUTED vertex order."""
    v_pad, n = layout.v_pad, layout.num_real
    if spec.combine == "sum":                      # pagerank
        vals = np.zeros(v_pad, np.float32)
        vals[layout.perm] = np.float32(1.0 / n)
        return vals
    vals = np.full(v_pad, INF_I32, np.int32)
    if spec.name == "wcc":
        # original ids as component seeds: the converged minimum is the
        # same vertex id under every placement (bit-identical results)
        vals[layout.perm] = np.arange(n, dtype=np.int32)
    else:                                          # bfs / sssp
        vals[layout.perm[source]] = 0
    return vals


def init_active(spec: AppSpec, layout, source: int = 0) -> np.ndarray:
    """(v_pad,) bool: who sends in superstep 1 (permuted order)."""
    act = np.zeros(layout.v_pad, bool)
    if spec.name in ("bfs", "sssp"):
        act[layout.perm[source]] = True
    else:
        act[layout.perm] = True
    return act


def finalize_values(spec: AppSpec, values: np.ndarray) -> np.ndarray:
    """Oracle-comparable view: BFS/SSSP unreached -> inf (float), the
    rest pass through."""
    if spec.name in ("bfs", "sssp"):
        out = values.astype(np.float64)
        return np.where(values >= INF_I32, np.inf, out)
    return values
