"""Partition-aware Pregel execution: one device, or SPMD over a mesh.

The consumer side of Spinner: given any vertex placement
(``apps.layout``), run a vertex program to its end.  Each superstep is
the JAX package's superstep on one rank's shard:

  * ``send`` -- the message vector (PageRank: ``values / max(deg, 1)``;
    min workloads: ``values``);
  * on a mesh, the exchange plan (``core.comm``: allgather, halo,
    halo_delta or delta) turns the ranks' send slices into the lookup the
    frontier edges read, and reports the superstep's wire bytes, which
    accumulate on the device;
  * the interior reduce (``pregel_reduce``, K3's counterpart) folds every
    interior edge's message into a (v_local,) partial -- it reads only
    the rank's own send slice;
  * the frontier combine (``pregel_combine``, K4's counterpart) folds the
    frontier edges, read through the lookup, into that partial and
    applies the vertex update; at one device the frontier is empty, so it
    is the vertex update alone;
  * ``msgs`` adds the out-degrees of the rank's vertices that changed in
    the PREVIOUS superstep (each sender's out-edges end at one combiner),
    and ``active`` counts this superstep's changes over every rank.

With ``overlap`` the superstep is ``start_exchange -> interior reduce ->
finish_exchange -> frontier combine``: the collective is in flight while
the interior is reduced (on a CUDA card NCCL runs on its own stream).
Without it the exchange completes first.  Both call the same pair on the
same inputs, so both give the same bits.

The engine is SPMD over ``torch.distributed``: every process of the
mesh's group runs the same host code on its own shard.  PyTorch has no
device-side while loop, so the host drives the supersteps.  A halting
workload sums its changed count over the ranks and reads it once per
superstep, so every rank stops at the same superstep and no kernel is
launched after the halt: each kernel's launches equal the supersteps.  A
fixed-length workload (PageRank) reads nothing until the end.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.comm import gather_shards, mesh_comm
from ..core.engine import resolve_device
from ..core.graph import Graph
from ..kernels import ref
from ..kernels.pregel_combine import pregel_combine, pregel_reduce
from .layout import AppShard, build_app_layout
from .workloads import APPS, finalize_values, init_active, init_values

# combine backend -> (interior reduce, frontier combine); same signatures
COMBINE_BACKENDS = {
    "cuda": (pregel_reduce, pregel_combine),
    "torch": (ref.pregel_reduce_ref, ref.pregel_combine_ref),
}


class AppState(NamedTuple):
    """The superstep carry: tensors on the run's device (the rank's
    shard), counters on the host."""
    values: torch.Tensor    # (v_local,) vertex values, placed+padded order
    changed: torch.Tensor   # (v_local,) bool: improved last superstep
    step: int               # supersteps completed
    active: int             # changed count of the last superstep (all ranks)
    msgs: torch.Tensor      # f32 scalar: messages this rank combined so far


@dataclasses.dataclass
class AppResult:
    """One application run on one placement.

    ``values`` is in ORIGINAL vertex order, oracle-comparable (BFS/SSSP:
    float with inf for unreached), the same on every rank.  ``plan`` is
    the exchange plan's name (``"none"`` without a mesh), ``wire_bytes``
    the device-accumulated total it moved (0 at one device).
    ``device_messages`` holds the (ndev,) combined-message counts, whose
    max/mean ``straggler_skew`` is the barrier-idle proxy of the paper's
    Table 4 model; ``edge_counts`` the per-device stored-edge load.
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
            mesh=None, axis: str = "data", plan: Optional[str] = None,
            combine: str = "cuda", overlap: bool = True,
            iters: Optional[int] = None, max_steps: Optional[int] = None,
            source: int = 0, damping: float = 0.85,
            delta_cap: Optional[int] = None, device=None) -> AppResult:
    """Run ``workload`` (pagerank, wcc, bfs or sssp) on ``graph`` placed by
    ``labels`` -- any per-vertex assignment: a Spinner partition (from the
    port or the JAX package), or the hash baseline.

    ``combine="cuda"`` runs the hand-written kernels, ``"torch"`` the plain
    PyTorch versions (the oracle).  PageRank runs ``iters`` supersteps
    (default 20); the others run until no vertex changes, at most
    ``max_steps`` (default 4096).

    Without ``mesh`` the run is on one device: the CUDA card unless
    ``device="cpu"`` asks for the CPU.  With a ``DeviceMesh`` from
    ``repro_torch.launch.mesh.make_partition_mesh`` it is SPMD over the
    group of ``axis``: call it on every rank; each holds its shard on the
    mesh's device (a ``device`` that disagrees raises), and each returns
    the whole result.  ``plan`` picks the exchange (default per workload:
    halo for PageRank's dense frontier, halo_delta for the shrinking one
    of WCC/BFS/SSSP), ``delta_cap`` the delta plan's buffer, ``overlap``
    the in-flight-collective schedule (bit-identical either way).
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
    if spec.halts:
        n_steps = max_steps or spec.default_iters
    else:
        n_steps = iters or spec.default_iters
    reduce_fn, combine_fn = COMBINE_BACKENDS[combine]

    if mesh is None:
        if plan is not None or delta_cap is not None:
            raise ValueError("plan= and delta_cap= shape the exchange "
                             "between devices: pass mesh=")
        layout = build_app_layout(graph, labels, resolve_device(device))
        comm, plan_name, exchange = None, "none", None
        shard = layout.shard(0)
    else:
        from ..launch.mesh import mesh_device
        comm = mesh_comm(mesh, axis)
        ndev = comm.ndev
        dev = mesh_device(mesh)
        if device is not None:
            want = torch.device(device)
            if want.type != dev.type or want.index not in (None, dev.index):
                raise ValueError(f"the mesh is on {dev}, but device="
                                 f"{device!r} asks for {want}")
        layout = build_app_layout(graph, labels, dev, ndev=ndev)
        plan_name = plan or spec.default_plan
        plan_obj = layout.exchange_plan(graph, plan_name, delta_cap)
        shard = layout.shard(comm.rank, plan_obj)
        exchange = (plan_obj, comm,
                    tuple(plan_obj.device_args(comm.rank, dev)),
                    bool(overlap))
    step = make_superstep(spec, shard, reduce_fn, combine_fn, damping,
                          layout.num_real, exchange)

    dev = layout.device
    rows = slice(shard.offset, shard.offset + shard.v_local)
    act0 = init_active(spec, layout, source)
    state = AppState(
        values=torch.from_numpy(
            init_values(spec, layout, source)[rows]).to(dev),
        changed=torch.from_numpy(act0[rows]).to(dev), step=0,
        active=int(act0.sum()),
        msgs=torch.zeros((), dtype=torch.float32, device=dev))
    aux = None
    wire = torch.zeros((), dtype=torch.float32, device=dev)
    while state.step < n_steps and (not spec.halts or state.active > 0):
        state, aux, xbytes = step(state, aux)
        if xbytes is not None:
            wire = wire + xbytes

    values, msgs = state.values, state.msgs.reshape(1)
    if comm is not None:
        values, msgs = gather_shards(values, comm), gather_shards(msgs, comm)
    msgs = msgs.cpu().numpy().astype(np.float64)
    wire_bytes = float(wire)
    return AppResult(
        workload=spec.name, plan=plan_name, ndev=layout.ndev,
        values=finalize_values(spec, layout.unpermute(values.cpu().numpy())),
        supersteps=state.step,
        converged=(not spec.halts) or state.active == 0,
        wire_bytes=wire_bytes,
        wire_bytes_per_step=wire_bytes / max(state.step, 1),
        device_messages=msgs,
        straggler_skew=float(msgs.max() / msgs.mean()) if msgs.sum() > 0
        else 1.0,
        edge_counts=layout.edge_counts.copy())


def make_superstep(spec, shard: AppShard, reduce_fn, combine_fn,
                   damping: float, num_real: int, exchange=None):
    """``step(state, aux) -> (state, aux, wire_bytes)``: one superstep of
    workload ``spec`` on ``shard``, through ``reduce_fn`` / ``combine_fn``
    (a pair of ``COMBINE_BACKENDS``).

    ``exchange`` is ``None`` at one device (the frontier is empty and the
    lookup is the send vector itself; ``aux`` passes through and the wire
    bytes are ``None``), or ``(plan, comm, plan_args, overlap)`` on a
    mesh, where ``aux`` is the plan's carried state: ``None`` before the
    first superstep, which builds it from its send vector (the plan's
    ``init_aux``).  A halting workload's step sums its changed count over
    the ranks and reads it back to the host.
    """
    pagerank = spec.combine == "sum"
    kw = dict(combine=spec.combine, bias=spec.bias)
    ckw = dict(kw, update="pagerank" if pagerank else "min",
               damping=damping)
    # PageRank's teleport term, computed in double and cast once
    base = float(np.float32((1.0 - damping) / num_real))
    share = torch.clamp(shard.deg_cnt, min=1.0)

    def step(s: AppState, aux):
        send = s.values / share if pagerank else s.values
        xbytes = None
        if exchange is None:
            partial = reduce_fn(send, *shard.interior, **kw)
            lookup = send
        else:
            plan, comm, args, overlap = exchange
            if aux is None:
                aux = plan.init_aux(send, comm, *args)
            if overlap:
                pending = plan.start_exchange(send, aux, comm, *args)
                partial = reduce_fn(send, *shard.interior, **kw)
                lookup, aux, xbytes = plan.finish_exchange(pending)
            else:
                lookup, aux, xbytes = plan.exchange(send, aux, comm, *args)
                partial = reduce_fn(send, *shard.interior, **kw)
        new, chg = combine_fn(lookup, *shard.frontier, s.values, shard.valid,
                              base, acc_init=partial, **ckw)
        msgs = s.msgs + (shard.deg_cnt * s.changed.to(torch.float32)).sum()
        active = s.active
        if spec.halts:
            count = chg.sum()
            if exchange is not None:
                dist.all_reduce(count, group=exchange[1].group)
            active = int(count)
        return AppState(values=new, changed=chg, step=s.step + 1,
                        active=active, msgs=msgs), aux, xbytes

    return step
