"""Partition-aware Pregel execution on one device.

The consumer side of Spinner: given any vertex placement
(``apps.layout``), run a vertex program to its end.  Each superstep is
the JAX package's superstep at one device:

  * ``send`` -- the message vector (PageRank: ``values / max(deg, 1)``;
    min workloads: ``values``);
  * the interior reduce (``pregel_reduce``, K3's counterpart) folds every
    interior edge's message into a (v_pad,) partial;
  * the frontier combine (``pregel_combine``, K4's counterpart) folds the
    frontier edges into that partial and applies the vertex update; at
    one device the frontier is empty, so it is the vertex update alone;
  * ``msgs`` adds the out-degrees of the vertices that changed in the
    PREVIOUS superstep (each sender's out-edges end at one combiner), and
    ``active`` counts this superstep's changes.

PyTorch has no device-side while loop, so the host drives the
supersteps.  A halting workload reads ``active`` once per superstep and
stops when it reaches 0; no kernel is launched after the halt, so each
kernel's launches equal the supersteps.  A fixed-length workload
(PageRank) reads nothing until the end.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.engine import resolve_device
from ..core.graph import Graph
from ..kernels import ref
from ..kernels.pregel_combine import pregel_combine, pregel_reduce
from .layout import AppLayout, build_app_layout
from .workloads import APPS, finalize_values, init_active, init_values

# combine backend -> (interior reduce, frontier combine); same signatures
COMBINE_BACKENDS = {
    "cuda": (pregel_reduce, pregel_combine),
    "torch": (ref.pregel_reduce_ref, ref.pregel_combine_ref),
}


class AppState(NamedTuple):
    """The superstep carry: tensors on the run's device, counters on the
    host."""
    values: torch.Tensor    # (v_pad,) vertex values, placed+padded order
    changed: torch.Tensor   # (v_pad,) bool: improved last superstep
    step: int               # supersteps completed
    active: int             # changed count of the last superstep
    msgs: torch.Tensor      # f32 scalar: messages combined so far


@dataclasses.dataclass
class AppResult:
    """One application run on one placement.

    ``values`` is in ORIGINAL vertex order, oracle-comparable (BFS/SSSP:
    float with inf for unreached).  At one device there is no exchange:
    ``plan`` is ``"none"`` and the wire bytes are 0.
    ``device_messages`` holds the (1,) combined-message count, whose
    max/mean ``straggler_skew`` is the barrier-idle proxy of the paper's
    Table 4 model (1.0 at one device); ``edge_counts`` the stored-edge
    load.
    """
    workload: str
    plan: str
    ndev: int
    values: np.ndarray
    supersteps: int
    converged: bool
    wire_bytes: float
    wire_bytes_per_step: float
    device_messages: np.ndarray
    straggler_skew: float
    edge_counts: np.ndarray


def run_app(graph: Graph, labels: np.ndarray, workload: str, *,
            combine: str = "cuda", iters: Optional[int] = None,
            max_steps: Optional[int] = None, source: int = 0,
            damping: float = 0.85, device=None) -> AppResult:
    """Run ``workload`` (pagerank, wcc, bfs or sssp) on ``graph`` placed by
    ``labels`` -- any per-vertex assignment: a Spinner partition (from the
    port or the JAX package), or the hash baseline.

    ``combine="cuda"`` runs the hand-written kernels, ``"torch"`` the plain
    PyTorch versions (the oracle).  PageRank runs ``iters`` supersteps
    (default 20); the others run until no vertex changes, at most
    ``max_steps`` (default 4096).  The run is on the CUDA card unless
    ``device="cpu"`` asks for the CPU.  The multi-device engine's options
    (mesh, exchange plan, overlap, tiles) come with the sharded engine.
    """
    spec = APPS.get(workload)
    if spec is None:
        raise ValueError(f"unknown workload {workload!r}; "
                         f"available: {', '.join(sorted(APPS))}")
    if combine not in COMBINE_BACKENDS:
        raise ValueError(f"unknown combine {combine!r}; "
                         f"available: {', '.join(sorted(COMBINE_BACKENDS))}")
    if not 0 <= source < graph.num_vertices:
        raise ValueError(f"source {source} outside [0, "
                         f"{graph.num_vertices})")
    dev = resolve_device(device)
    layout = build_app_layout(graph, labels, dev)
    if spec.halts:
        n_steps = max_steps or spec.default_iters
    else:
        n_steps = iters or spec.default_iters
    reduce_fn, combine_fn = COMBINE_BACKENDS[combine]
    step = make_superstep(spec, layout, reduce_fn, combine_fn, damping)

    act0 = init_active(spec, layout, source)
    state = AppState(
        values=torch.from_numpy(init_values(spec, layout, source)).to(dev),
        changed=torch.from_numpy(act0).to(dev), step=0,
        active=int(act0.sum()),
        msgs=torch.zeros((), dtype=torch.float32, device=dev))
    while state.step < n_steps and (not spec.halts or state.active > 0):
        state = step(state)
    msgs = state.msgs.cpu().numpy().astype(np.float64).reshape(1)
    values = finalize_values(spec,
                             layout.unpermute(state.values.cpu().numpy()))
    return AppResult(
        workload=spec.name, plan="none", ndev=1, values=values,
        supersteps=state.step,
        converged=(not spec.halts) or state.active == 0,
        wire_bytes=0.0, wire_bytes_per_step=0.0, device_messages=msgs,
        straggler_skew=float(msgs.max() / msgs.mean()) if msgs.sum() > 0
        else 1.0,
        edge_counts=layout.edge_counts.copy())


def make_superstep(spec, layout: AppLayout, reduce_fn, combine_fn,
                   damping: float):
    """``step(state) -> state``: one superstep of workload ``spec`` on
    ``layout``, through ``reduce_fn`` / ``combine_fn`` (a pair of
    ``COMBINE_BACKENDS``).  A halting workload's step reads the changed
    count back to the host."""
    pagerank = spec.combine == "sum"
    update = "pagerank" if pagerank else "min"
    # PageRank's teleport term, computed in double and cast once
    base = float(np.float32((1.0 - damping) / layout.num_real))
    share = torch.clamp(layout.deg_cnt, min=1.0)

    def step(s: AppState) -> AppState:
        send = s.values / share if pagerank else s.values
        partial = reduce_fn(send, layout.row_ptr, layout.dst,
                            combine=spec.combine, bias=spec.bias)
        new, chg = combine_fn(send, layout.frontier_row_ptr,
                              layout.frontier_dst, s.values, layout.valid,
                              base, combine=spec.combine, update=update,
                              damping=damping, bias=spec.bias,
                              acc_init=partial)
        msgs = s.msgs + (layout.deg_cnt * s.changed.to(torch.float32)).sum()
        active = int(chg.sum()) if spec.halts else s.active
        return AppState(values=new, changed=chg, step=s.step + 1,
                        active=active, msgs=msgs)

    return step
