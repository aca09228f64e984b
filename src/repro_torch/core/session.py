"""PartitionSession: a device-resident handle for continuous partitioning.

Spinner's pitch is CONTINUOUS partitioning (Sections 3.4-3.5): react to a
stream of graph changes and cluster resizes by restarting from the previous
assignment, not from scratch.  ``PartitionSession`` holds what such a
service amortizes::

    from repro_torch.core import EngineOptions, SpinnerConfig, open_session

    opts = EngineOptions(engine="fused")
    with open_session(g, SpinnerConfig(k=32), opts) as s:
        res = s.partition()                          # cold: O(E) upload
        while serving:
            res = s.adapt(edge_updates=next_batch())  # warm: O(|delta|)
            res = s.adapt(edge_updates=batch, frontier=True)  # dirty set
            if cluster_resized(new_k):
                res = s.resize(new_k)

Lifecycle: ``open -> partition / adapt / resize / update / stage ->
close``.  The session owns the (graph, config, options) triple, the
previous stable labels (``adapt``/``resize`` default to them) and, once an
``edge_updates`` batch arrives, the on-device delta (``core.delta``).

On a mesh (``EngineOptions(mesh=...)`` or ``engine="sharded"``) every
process of the mesh opens the same session and makes the same calls:
``partition``, ``adapt``, ``resize``, ``update`` and ``run_app`` run the
sharded engine, and ``stats()`` adds the exchange plan's volumes under
``"exchange"``.  The delta fast path there merges each rank's share of a
batch into a delta segment over its rows (``core.delta``'s sharded mode)
and restarts the sharded runner -- or, with ``frontier=True``, the sharded
frontier runner (``engine.run_sharded_frontier``'s loop) -- over base and
delta segments.  Eligible: the torch backend (the counterpart of the
reference's XLA backend) with ``overlap`` off and the allgather or delta
plan; the CUDA backend's shards are rebuilt from the host graph, as the
reference's Pallas backend retiles on the host, and its
``adapt(frontier=True)`` raises ``ValueError`` as the reference's does.
The halo plans fall back too: their dst are ``[local | halo]`` slots, and a
delta entry would need a halo slot the plan does not have.  The reference
takes its fast path under ``halo_delta`` and writes global ids into those
slots, which gives another result than its own rebuild (ROADMAP.md §3);
the port keeps the rebuild's result.

Compile accounting has no counterpart here: PyTorch runs eagerly and the
kernels are built once per source hash, so nothing compiles per graph.
``stats()`` reports ``uploads`` instead: the O(E) host-to-device uploads
of a padded CSR that the session's runs caused (``run_app``'s placed
layout is built and cached by ``repro_torch.apps`` and not counted).  The
warm-adapt rule is zero new uploads and zero host rebuilds.

Delta-proportional adapt (the ``edge_updates`` fast path): a warm
``adapt(edge_updates=(src, dst))`` that fits the edge bucket's slack costs
O(|delta|) on the host and the wire.  The batch is folded through the pair
ledger and merged into the session's delta segment on the device (no host
CSR rebuild, no O(E) re-upload); the logical graph update is kept in a
pending log and only materialized on the host when something needs the
``Graph`` object (``partition()``, ``stage()``, a growing batch, slack
overflow -- which falls back to the bit-identical rebuild).  Eligible:
the fused engine (``engine="fused"``, or ``"auto"`` with
``record_history=False``) with ``pad="bucket"``, on the torch backend or
the CUDA backend's fused kernel (its dense score kernel reads no delta
segment); everything else takes the fallback and is counted in
``stats()["delta"]["fallback_adapts"]``.  The counters match the
reference's XLA mode, except the upload bytes, which follow this layout
(12 bytes an appended entry).

Frontier reconvergence (``adapt(..., frontier=True)``): scores only the
dirty vertex set -- endpoints of changed pairs on the fast path, the
batch's endpoints on the fallback, expanded one hop per iteration along
edges out of vertices that changed label -- and halts when no active
vertex wants to move (``engine.make_frontier_step``).  The result carries
``scored_vertices`` / ``scored_per_iter``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import rng
from . import delta as _delta
from . import engine as _engine
from . import metrics
from .engine import EngineOptions
from .graph import Graph, add_edges
from .incremental import elastic_relabel, extend_labels
from .spinner import PartitionResult, SpinnerConfig, prepare_init

_ENGINES = ("auto", "fused", "sharded", "chunked", "host")

# The one closed-session error, shared by every entry point: a serving tier
# retires sessions aggressively and matches on this message, so it must not
# vary by code path.
_CLOSED_MSG = ("PartitionSession is closed; open a new session "
               "(close() released its state and is idempotent)")


@dataclasses.dataclass
class _DeltaFast:
    """The session's delta fast-path state (see ``repro_torch.core.delta``).

    Built lazily on the first eligible ``adapt(edge_updates=...)`` -- the
    one O(E) cold cost (the pair-key index).  ``merged`` counts the prefix
    of the session's pending log already merged into ``dd``.  On a mesh
    ``dd`` is this rank's segment and ``v_pad`` the sharded layout's.
    """

    tracker: _delta.DeltaTracker
    dd: _delta.DeviceDelta
    v_pad: int
    merged: int = 0


class PartitionSession:
    """Device-resident handle: open -> partition/adapt/resize/update -> close.

    See the module docstring for the lifecycle.  All runs go through the
    same engine runners as the one-shot ``partition``; the session adds the
    previous-labels memory, the upload accounting and the on-device delta.
    """

    def __init__(self, graph: Graph, cfg: SpinnerConfig,
                 options: Optional[EngineOptions] = None):
        opts = options if options is not None else EngineOptions()
        self._mesh = None
        if opts.mesh is not None or opts.engine == "sharded":
            from ..launch.mesh import mesh_device
            self._mesh = (opts.mesh if opts.mesh is not None
                          else _engine._default_partition_mesh(opts.device))
            dev = mesh_device(self._mesh)
        else:
            dev = opts.resolved_device()
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._pending: List[tuple] = []   # validated directed delta batches
        self._dirty: Optional[np.ndarray] = None  # endpoints since last run
        self._delta: Optional[_DeltaFast] = None
        self._fast_adapts = 0
        self._fallback_adapts = 0
        self._host_rebuilds = 0
        self._delta_bytes_last = 0
        self._delta_bytes_total = 0
        self._uploads = 0
        self.graph = graph
        self.cfg = cfg
        self.options = opts
        self._prev: Optional[np.ndarray] = None
        self._last: Optional[PartitionResult] = None
        self._staged: Optional[Graph] = None
        self._runs = 0
        self._delta_seq = 0             # delta batches accepted, ever
        self._closed = False

    # -- the logical graph (base + pending delta log) ----------------------

    @property
    def graph(self) -> Graph:
        """The session's logical graph.  Reading it MATERIALIZES any
        pending edge deltas into a host Graph (one ``add_edges`` rebuild
        -- the cost the fast path defers); ``stats()`` reports the base
        graph plus the pending-log counters without materializing."""
        if self._pending:
            self._materialize()
        return self._graph

    @graph.setter
    def graph(self, g: Graph) -> None:
        self._graph = g
        self._pending = []
        self._dirty = None
        self._delta = None

    def _materialize(self) -> None:
        """Fold the pending delta log into a host Graph.  One coalesced
        ``add_edges`` call: the union-of-directions weight semantics are
        order-independent, so batching is exact."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        src = np.concatenate([b[0] for b in pending])
        dst = np.concatenate([b[1] for b in pending])
        self._graph = add_edges(self._graph, src, dst)
        self._host_rebuilds += 1
        self._delta = None   # the device segment was keyed to the old base

    def _mark_dirty(self, *vertex_sets) -> None:
        if self._dirty is None:
            self._dirty = np.zeros(self._graph.num_vertices, bool)
        for vs in vertex_sets:
            if len(vs):
                self._dirty[np.asarray(vs)] = True

    def _note_upload(self, graph: Graph) -> None:
        """Count the O(E) upload a run on ``graph`` is about to cause: the
        padded CSR goes to the device once per graph object."""
        padded, _ = _engine.padded_view(graph, self.options)
        if self._mesh is not None:
            from ..launch.mesh import mesh_rank, mesh_size
            from .distributed import has_rank_shard
            axis = self.options.axis
            if not has_rank_shard(padded, mesh_size(self._mesh, axis),
                                  mesh_rank(self._mesh, axis), self._device):
                self._uploads += 1
        elif not padded.on_device(self._device):
            self._uploads += 1

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Release the session's references (graph uploads die with the
        graph).  Idempotent; every later entry point raises the same
        ``RuntimeError`` (one fixed message)."""
        if self._closed:
            return
        self._prev = None
        self._last = None
        self._staged = None
        self._pending = []
        self._delta = None
        self._dirty = None
        self._closed = True

    def __enter__(self) -> "PartitionSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(_CLOSED_MSG)

    # -- the four drivers --------------------------------------------------

    def partition(self, init: Optional[np.ndarray] = None,
                  record_history: Optional[bool] = None,
                  callback: Optional[Callable[[int, dict], None]] = None,
                  ) -> PartitionResult:
        """Run to a stable state from ``init`` (or a fresh random start)."""
        self._check_open()
        return self._run(init, record_history, callback)

    def adapt(self, new_graph: Optional[Graph] = None,
              prev: Optional[np.ndarray] = None, *,
              edge_updates: Optional[tuple] = None,
              num_vertices: Optional[int] = None,
              record_history: Optional[bool] = None,
              callback: Optional[Callable[[int, dict], None]] = None,
              frontier: Optional[bool] = None,
              ) -> PartitionResult:
        """Incremental restart (Section 3.4) from the previous labels.

        Rebinds the session to ``new_graph`` (or to the current graph
        extended by ``edge_updates=(src, dst)``; neither = the snapshot
        previously ``stage()``-d if one is pending, else re-run on the
        current graph, e.g. after ``update()``), carries ``prev`` labels
        (default: the last result) extending new vertices as -1 ->
        least-loaded, and restarts.

        An ``edge_updates`` delta that fits the slack takes the O(|delta|)
        fast path (see the module docstring for eligibility); otherwise it
        falls back to the bit-identical rebuild.  ``frontier=True``
        reconverges only the dirty vertex set and drain-halts; the
        result's ``scored_per_iter`` reports per-iteration scored-vertex
        counts.
        """
        self._check_open()
        if new_graph is not None and edge_updates is not None:
            raise ValueError("pass at most one of new_graph/edge_updates")
        batch = None
        if edge_updates is not None:
            e_src, e_dst = edge_updates
            e_src, e_dst = _delta.check_edge_updates(
                e_src, e_dst, self._graph.num_vertices, num_vertices)
            self._delta_seq += 1
            grows = (num_vertices is not None
                     and num_vertices > self._graph.num_vertices)
            if not grows:
                prev_arr = self._require_prev(prev)
                res = self._try_fast_adapt(e_src, e_dst, prev_arr,
                                           frontier, record_history,
                                           callback)
                if res is not None:
                    self._staged = None
                    return res
                self._fallback_adapts += 1
            # fallback: the classic host rebuild (bit-identical oracle)
            new_graph = add_edges(self.graph, e_src, e_dst,
                                  num_vertices=num_vertices)
            self._host_rebuilds += 1
            batch = (e_src, e_dst)
        prev = self._require_prev(prev)
        if new_graph is None and self._staged is not None:
            new_graph = self._staged
        dirty, old_v = self._dirty, self._graph.num_vertices
        if new_graph is not None:
            # any rebinding -- staged or explicit -- supersedes a pending
            # staged snapshot, built against the graph this call replaces
            self._staged = None
            self.graph = new_graph
        init = extend_labels(prev, self.graph.num_vertices)
        if frontier:
            active = self._frontier_active(dirty, old_v, batch,
                                           full=batch is None)
            return self._run_frontier(init, active, record_history,
                                      callback)
        return self._run(init, record_history, callback)

    def _frontier_active(self, dirty, old_v: int, batch,
                         full: bool) -> np.ndarray:
        """Initial active mask for a frontier fallback run: accumulated
        dirty endpoints + this call's batch endpoints + grown vertices.
        With no delta provenance at all (``full``) every vertex starts
        active and frontier mode degenerates to drain-halting LPA."""
        V = self._graph.num_vertices
        active = np.zeros(V, bool)
        if full and dirty is None:
            active[:] = True
            return active
        if dirty is not None:
            active[:dirty.shape[0]] = dirty
        active[old_v:] = True
        if batch is not None:
            active[batch[0]] = True
            active[batch[1]] = True
        return active

    def stage(self, new_graph: Optional[Graph] = None, *,
              edge_updates: Optional[tuple] = None,
              num_vertices: Optional[int] = None) -> "PartitionSession":
        """Double-buffer the NEXT snapshot: build its padded view and
        upload it now, so a following ``adapt()`` starts from a
        device-resident bind.  The staged snapshot is consumed by the next
        argument-less ``adapt()``; staging again replaces it, and any other
        rebinding (``update()``, ``adapt(new_graph=...)`` /
        ``adapt(edge_updates=...)``) discards it.  Staging materializes any
        pending fast-path deltas first.  Chainable."""
        self._check_open()
        new_graph = self._graph_delta(new_graph, edge_updates, num_vertices)
        if new_graph is None:
            raise ValueError("stage() needs new_graph or edge_updates")
        self._prestage(new_graph)
        self._staged = new_graph
        return self

    def _graph_delta(self, new_graph: Optional[Graph], edge_updates,
                     num_vertices: Optional[int]) -> Optional[Graph]:
        """Resolve the mutually-exclusive new_graph/edge_updates pair;
        ``edge_updates=(src, dst)`` extends the current graph (validated
        before any state changes)."""
        if new_graph is not None and edge_updates is not None:
            raise ValueError("pass at most one of new_graph/edge_updates")
        if edge_updates is not None:
            e_src, e_dst = edge_updates
            e_src, e_dst = _delta.check_edge_updates(
                e_src, e_dst, self._graph.num_vertices, num_vertices)
            new_graph = add_edges(self.graph, e_src, e_dst,
                                  num_vertices=num_vertices)
            self._host_rebuilds += 1
        return new_graph

    def _prestage(self, graph: Graph) -> None:
        """Build the padded view and upload it, as ``_run`` would for
        ``graph`` (both are cached per graph object, which the later
        ``adapt()`` receives)."""
        self._note_upload(graph)
        if self._mesh is not None:
            _engine._sharded_parts(graph, self.cfg, self.options, self._mesh,
                                   self.options.axis)
            return
        padded, _ = _engine.padded_view(graph, self.options)
        padded.to_device(self._device)

    def resize(self, k_new: int, prev: Optional[np.ndarray] = None,
               seed: Optional[int] = None,
               record_history: Optional[bool] = None,
               callback: Optional[Callable[[int, dict], None]] = None,
               ) -> PartitionResult:
        """Elastic restart (Section 3.5, Eq. 10) to ``k_new`` partitions:
        relabel the previous assignment probabilistically, update the
        session's config to the new k, and restart."""
        self._check_open()
        prev = self._require_prev(prev)
        k_old = self.cfg.k
        cfg_new = dataclasses.replace(self.cfg, k=k_new)
        init = elastic_relabel(prev, k_old, k_new,
                               seed=cfg_new.seed if seed is None else seed)
        # run first, commit the new k only on success: a rejected call
        # (bad history/callback combination) must not leave the session
        # with k_new but labels from k_old
        res = self._run(init, record_history, callback, cfg=cfg_new)
        self.cfg = cfg_new
        return res

    def update(self, edge_src, edge_dst, num_vertices: Optional[int] = None,
               directed: bool = True) -> "PartitionSession":
        """Apply a graph delta WITHOUT running; the next ``adapt()`` (or
        ``partition()``) sees the extended graph.  Discards any pending
        staged snapshot.  Same-vertex-set deltas join the session's
        pending log (validated now, materialized lazily), so a following
        ``adapt(edge_updates=...)``/``adapt()`` stays on the O(|delta|)
        fast path; a delta that grows the vertex set rebuilds the host
        graph right away.  Chainable."""
        self._check_open()
        self._staged = None
        e_src, e_dst = _delta.check_edge_updates(
            edge_src, edge_dst, self._graph.num_vertices, num_vertices)
        self._delta_seq += 1
        if num_vertices is not None \
                and num_vertices > self._graph.num_vertices:
            self.graph = add_edges(self.graph, e_src, e_dst,
                                   directed=directed,
                                   num_vertices=num_vertices)
            self._host_rebuilds += 1
            return self
        if not directed:
            e_src, e_dst = (np.concatenate([e_src, e_dst]),
                            np.concatenate([e_dst, e_src]))
        self._pending.append((e_src, e_dst))
        self._mark_dirty(e_src, e_dst)   # conservative: all endpoints
        return self

    # -- the delta fast path ----------------------------------------------

    def _fast_mode(self, record_history, callback) -> bool:
        """Whether the session's configuration supports the on-device
        delta merge (see the module docstring)."""
        opts = self.options
        if opts.pad != "bucket":
            return False                # no slack to fill
        if callback is not None or record_history is True:
            return False                # per-iteration visibility paths
        if self._mesh is not None:
            from ..launch.mesh import mesh_size
            ndev = mesh_size(self._mesh, opts.axis)
            if getattr(opts.backend(), "name", None) != "torch":
                return False            # the CUDA shards rebuild on the host
            if opts.resolved_overlap(ndev) == "on":
                return False            # overlap's split arrays differ
            # halo dst slots aren't global ids; the reference refuses only
            # "halo" and gets halo_delta wrong (ROADMAP.md §3)
            return opts.resolved_label_exchange(ndev) not in ("halo",
                                                              "halo_delta")
        if opts.engine not in ("auto", "fused"):
            return False                # chunked/host replay per-iteration
        if opts.engine == "auto" and record_history is not False:
            return False                # auto+history resolves to chunked
        backend = opts.backend()
        if not hasattr(backend, "delta_args"):
            return False                # a custom backend reads no delta
        if getattr(backend, "name", None) == "cuda" \
                and opts.resolved_fused_update() != "on":
            return False                # the dense score kernel neither
        return True

    def _delta_init(self) -> _DeltaFast:
        """Cold-start the fast path from the CURRENT base graph: pair-key
        index + an empty device segment over the (cached) upload.  O(E)
        host work, paid once per base graph."""
        graph = self._graph
        self._note_upload(graph)
        padded, _ = _engine.padded_view(graph, self.options)
        tracker = _delta.DeltaTracker(graph)
        if self._mesh is not None:
            from .distributed import segment_widths
            sg, _, _, bind, comm = _engine._sharded_parts(
                graph, self.cfg, self.options, self._mesh, self.options.axis)
            dd = _delta.init_sharded_csr(
                bind.deg_w, comm.rank,
                segment_widths(padded, comm.ndev, pad=True))
            return _DeltaFast(tracker=tracker, dd=dd, v_pad=sg.num_vertices)
        dd = _delta.init_single_csr(padded.to_device(self._device),
                                    graph.num_directed_entries)
        return _DeltaFast(tracker=tracker, dd=dd, v_pad=padded.num_vertices)

    def _fast_prepare(self, e_src, e_dst, prev, record_history,
                      callback) -> Optional[tuple]:
        """Merge (pending log + this batch) into the device segment and
        build the warm restart state.  Returns ``(fs, state)`` or None when
        ineligible / on slack overflow (-> the caller rebuilds)."""
        if not self._fast_mode(record_history, callback):
            return None
        if prev.shape[0] != self._graph.num_vertices:
            return None     # shorter prev needs the -1/least-loaded init
        if self._delta is None:
            self._delta = self._delta_init()
        fs = self._delta
        dd, tracker = fs.dd, fs.tracker
        nbytes = 0
        batches = self._pending[fs.merged:] + [(e_src, e_dst)]
        for bs, bd in batches:
            out = _delta.apply_delta(tracker, dd, bs, bd,
                                     _engine.merge_delta)
            if out is None:
                return None          # slack overflow -> rebuild fallback
            dd, plan, b = out
            nbytes += b
            self._mark_dirty(plan.touched)
        self._pending.append((e_src, e_dst))
        fs.dd, fs.merged = dd, len(self._pending)
        self._delta_bytes_last = nbytes
        self._delta_bytes_total += nbytes
        self._fast_adapts += 1

        key, _ = rng.split(rng.PRNGKey(self.cfg.seed))
        labels_p = _engine.pad_labels(
            torch.from_numpy(np.ascontiguousarray(prev)).to(self._device),
            fs.v_pad)
        if self._mesh is None:
            loads = _engine.device_loads(labels_p, fs.dd.deg_w, self.cfg.k)
        else:
            from .comm import mesh_comm
            # each rank's rows, summed over the ranks (integer sums: exact)
            lo, vl = fs.dd.rank * fs.dd.v_per_dev, fs.dd.v_per_dev
            loads, = _engine.make_rank_sum(
                mesh_comm(self._mesh, self.options.axis))([
                    _engine.device_loads(labels_p[lo:lo + vl], fs.dd.deg_w,
                                         self.cfg.k)])
        return fs, _engine.init_state(labels_p, loads, key)

    def _fast_bind(self, fs: _DeltaFast,
                   frontier: bool) -> _engine.GraphBind:
        """The GraphBind over the base upload plus the merged delta
        segment (row-for-row what ``make_bind`` builds from a rebuilt host
        graph, as far as every score sum goes).  The capacity is computed
        in float64 from the tracked total weight, then made a float32
        device scalar."""
        cfg, dd, opts = self.cfg, fs.dd, self.options
        backend = opts.backend()
        args_of = (backend.fused_graph_args
                   if opts.resolved_fused_update() == "on"
                   else backend.graph_args)
        score = tuple(args_of(dd.csr))
        if dd.num_entries:
            score += tuple(backend.delta_args(dd))
        num_real = self._graph.num_vertices
        capacity = cfg.c * fs.tracker.total_weight / cfg.k
        return _engine.GraphBind(
            deg_w=dd.deg_w,
            capacity=torch.tensor(capacity, dtype=torch.float32,
                                  device=self._device),
            num_real=num_real,
            valid=torch.arange(fs.v_pad, device=self._device) < num_real,
            score=score,
            frontier=(((dd.csr.src, dd.csr.dst), (dd.src, dd.dst))
                      if frontier else ()))

    def _try_fast_adapt(self, e_src, e_dst, prev, frontier,
                        record_history, callback
                        ) -> Optional[PartitionResult]:
        """The O(|delta|) adapt: merge on device, restart warm.  Returns
        None when ineligible or when the batch overflows the slack (-> the
        caller rebuilds, bit-identically)."""
        out = self._fast_prepare(e_src, e_dst, prev, record_history,
                                 callback)
        if out is None:
            return None
        fs, state = out
        cfg, opts = self.cfg, self.options
        active = self._active_mask(fs.v_pad) if frontier else None
        if self._mesh is not None:
            state, hist = self._fast_sharded(fs, state, active)
            eng = "sharded"
        else:
            bind = self._fast_bind(fs, bool(frontier))
            if frontier:
                state, hist = _engine.frontier_loop(cfg, opts, state, active,
                                                    bind)
            else:
                state, hist = _engine.run_bound(cfg, opts, state, bind), None
            eng = "fused"
        res = self._finish_state(state, self._graph.num_vertices, eng, hist)
        self._dirty = None
        return res

    def _fast_sharded(self, fs: _DeltaFast, state, active):
        """The fast path's run on a mesh: the sharded runner (or, with an
        ``active`` mask, the sharded frontier loop) over this rank's bind
        with the merged delta segment added -- its degrees, its entries
        in the score arrays and the expansion segments -- and the capacity
        of the tracked total weight."""
        cfg, opts, dd = self.cfg, self.options, fs.dd
        frontier = active is not None
        _, plan, step, bind, comm = _engine._sharded_parts(
            self._graph, cfg, opts, self._mesh, opts.axis,
            frontier=frontier)
        score, expand = bind.score, bind.frontier
        if dd.num_entries:
            score += tuple(opts.backend().delta_args(dd))
            if frontier:
                expand += ((dd.src, dd.dst),)
        bind = bind._replace(
            deg_w=dd.deg_w, score=score, frontier=expand,
            capacity=torch.tensor(cfg.c * fs.tracker.total_weight / cfg.k,
                                  dtype=torch.float32, device=self._device))
        if frontier:
            return _engine.sharded_frontier_loop(cfg, plan, step, bind, comm,
                                                 state, active)
        return _engine.run_sharded_bound(cfg, opts, plan, step, bind, comm,
                                         state), None

    # -- scheduler-driven batched execution (repro_torch.serve) ------------

    def batchable(self) -> bool:
        """True when this session's adapts can ride the engine's batched
        same-bucket runner (``engine.run_batched``): single-device fused
        runs on the torch scatter backend, the counterpart of the
        reference's XLA backend.  Sharded, chunked and host sessions, and
        the CUDA backend (whose K1 runs per tenant), run serially through
        their own entry points instead."""
        self._check_open()
        opts = self.options
        if self._mesh is not None or opts.engine not in ("auto", "fused"):
            return False
        return getattr(opts.backend(), "name", None) == "torch"

    def batch_key(self) -> tuple:
        """Same-bucket compatibility key: sessions whose keys match give
        ``adapt_parts`` work items that share one batch (their
        ``engine.batch_signature``).  Reads the BASE graph (no
        pending-delta materialization)."""
        self._check_open()
        opts = self.options
        padded, _ = _engine.padded_view(self._graph, opts)
        return (_engine._static_cfg(self.cfg),
                _engine.backend_signature(opts.backend()),
                opts.resolved_fused_update() == "on",
                padded.num_vertices, padded.num_directed_entries)

    def adapt_parts(self, edge_updates: Optional[tuple] = None,
                    prev: Optional[np.ndarray] = None
                    ) -> Optional[tuple]:
        """Build -- without running -- this session's next adapt as a
        ``(state, bind, cfg, opts)`` work item for ``engine.run_batched``;
        None when the session is not ``batchable()``.

        Mirrors ``adapt(record_history=False)`` exactly: an eligible
        ``edge_updates`` batch takes the O(|delta|) fast path (one merge
        for the whole, possibly coalesced, batch); otherwise the rebuild
        (counted in ``fallback_adapts`` and ``host_rebuilds``) gives the
        same work item from the rebuilt graph's bind.  Without a batch a
        staged snapshot is consumed.  Feed the runner's output state to
        ``commit_adapt``; until then the previous labels are unchanged.
        """
        self._check_open()
        if not self.batchable():
            return None
        prev_arr = self._require_prev(prev)
        if edge_updates is not None:
            e_src, e_dst = _delta.check_edge_updates(
                edge_updates[0], edge_updates[1], self._graph.num_vertices,
                None)
            self._delta_seq += 1
            out = self._fast_prepare(e_src, e_dst, prev_arr, False, None)
            if out is not None:
                self._staged = None
                fs, state = out
                return state, self._fast_bind(fs, False), self.cfg, \
                    self.options
            self._fallback_adapts += 1
            new_graph = add_edges(self.graph, e_src, e_dst)
            self._host_rebuilds += 1
            self._staged = None
            self.graph = new_graph
        elif self._staged is not None:
            staged, self._staged = self._staged, None
            self.graph = staged
        graph, cfg, opts = self.graph, self.cfg, self.options
        init = extend_labels(prev_arr, graph.num_vertices)
        labels, loads, key = prepare_init(graph, cfg, init,
                                          device=self._device)
        self._note_upload(graph)
        bind, padded = _engine.make_bind(graph, cfg, opts, self._device)
        state = _engine.init_state(
            _engine.pad_labels(labels, padded.num_vertices), loads, key)
        return state, bind, cfg, opts

    def commit_adapt(self, state) -> PartitionResult:
        """Record a batched runner's output state as this session's new
        stable result -- the bookkeeping ``adapt`` does after its own run
        (labels sliced to the real vertices, previous labels advanced,
        dirty set cleared).  Reads the state back to the host."""
        self._check_open()
        res = self._finish_state(state, self._graph.num_vertices, "fused",
                                 None)
        self._dirty = None
        return res

    def _active_mask(self, v_pad: int) -> torch.Tensor:
        active = np.zeros(v_pad, bool)
        if self._dirty is not None:
            active[:self._dirty.shape[0]] = self._dirty
        return torch.from_numpy(active).to(self._device)

    def _finish_state(self, state, num_real: int, eng: str,
                      hist) -> PartitionResult:
        iters = int(state.iteration)
        if hist is not None:
            per_iter = tuple(float(x) for x in hist[:iters])
            scored = float(sum(per_iter))
        else:
            per_iter, scored = (), -1.0
        res = PartitionResult(
            labels=state.labels[:num_real].cpu().numpy(),
            loads=state.loads.cpu().numpy(), iterations=iters,
            halted=bool(state.halted), history=[],
            total_messages=float(state.total_messages), engine=eng,
            exchanged_bytes=float(state.exchanged_bytes),
            scored_vertices=scored, scored_per_iter=per_iter)
        self._last = res
        self._prev = res.labels
        self._runs += 1
        return res

    def _run_frontier(self, init, active, record_history,
                      callback) -> PartitionResult:
        """Frontier reconvergence on a materialized graph (the fallback
        compute path; the fast path drives the same loop off its merged
        device segment)."""
        if callback is not None or record_history is True:
            raise ValueError(
                "frontier=True records only per-iteration scored-vertex "
                "counts (PartitionResult.scored_per_iter); run without "
                "frontier for history/callbacks")
        graph, opts, cfg = self.graph, self.options, self.cfg
        if opts.engine in ("chunked", "host"):
            raise ValueError(
                f"frontier=True requires a while_loop engine (fused/"
                f"sharded/auto), not engine={opts.engine!r}")
        labels, loads, key = prepare_init(graph, cfg, init,
                                          device=self._device)
        self._note_upload(graph)
        if self._mesh is not None:
            state, hist = _engine.run_sharded_frontier(
                graph, cfg, labels, loads, key, active, mesh=self._mesh,
                axis=opts.axis, opts=opts)
            eng = "sharded"
        else:
            state, hist = _engine.run_frontier(graph, cfg, labels, loads,
                                               key, active, opts)
            eng = "fused"
        res = self._finish_state(state, graph.num_vertices, eng, hist)
        self._dirty = None
        return res

    def run_app(self, workload: str, labels: Optional[np.ndarray] = None,
                **kwargs):
        """Consume this session's partition: run a Pregel application
        (``"pagerank"`` / ``"wcc"`` / ``"bfs"`` / ``"sssp"``) on the
        session graph placed by its labels, through
        :func:`repro_torch.apps.run_app` on the session's device -- on the
        session's mesh and axis, if it has one (SPMD: every rank calls).

        ``labels`` defaults to the session's current stable assignment
        (``partition()`` must have run); pass any vector (e.g. the hash
        baseline) to A/B a placement on the same graph.  Keyword args go
        to ``run_app`` (``plan``, ``combine``, ``overlap``, ``iters``,
        ``source``, ...).
        """
        self._check_open()
        from ..apps import run_app as _run_app   # lazy: apps imports core
        if labels is None:
            labels = self._prev
            if labels is None:
                raise ValueError("no labels yet: run partition() first "
                                 "or pass labels= explicitly")
        if "mesh" not in kwargs and self._mesh is not None:
            kwargs["mesh"] = self._mesh
        kwargs.setdefault("axis", self.options.axis)
        kwargs.setdefault("device", self._device)
        return _run_app(self.graph, np.asarray(labels), workload, **kwargs)

    # -- introspection -----------------------------------------------------

    @property
    def labels(self) -> Optional[np.ndarray]:
        """The previous stable assignment (None before the first run)."""
        return self._prev

    @property
    def delta_watermark(self) -> int:
        """Monotone count of delta batches this session has accepted
        (``update()`` / ``adapt(edge_updates=)``), whether merged on
        device, pending, or already materialized."""
        return self._delta_seq

    @property
    def uploads(self) -> int:
        """O(E) host-to-device uploads of a padded CSR this session's runs
        caused (the port's counterpart of the reference's compile count)."""
        return self._uploads

    def export_state(self) -> dict:
        """The session's partition state as a flat dict of host arrays --
        the checkpointable surface (``repro_torch.ckpt``).

        O(V + k): the previous stable ``labels``, the ``loads`` they
        imply, the key every run derives from (``rng.PRNGKey(cfg.seed)``
        as ``uint32[2]``, the reference's bits; recorded for audit: runs
        are deterministic functions of graph, config and previous labels,
        which is what makes a restored session continue bit-identically),
        and the run and delta-watermark counters.  The graph is not
        included; it is rebuilt from the durable inputs on restore.
        """
        self._check_open()
        if self._prev is None:
            raise ValueError("no stable labels to snapshot; run "
                             "partition() first or import_state()")
        if self._last is not None:
            loads = np.asarray(self._last.loads, np.float32)
        else:                  # re-derive exactly as prepare_init does
            loads = np.zeros(self.cfg.k, np.float32)
            np.add.at(loads, self._prev,
                      np.asarray(self._graph.deg_w, np.float32))
        return {
            "labels": np.asarray(self._prev, np.int32),
            "loads": loads,
            "rng_key": np.asarray(rng.PRNGKey(self.cfg.seed), np.uint32),
            "runs": np.int64(self._runs),
            "delta_watermark": np.int64(self._delta_seq),
            "k": np.int64(self.cfg.k),
            "num_vertices": np.int64(self._graph.num_vertices),
        }

    def import_state(self, state: dict) -> "PartitionSession":
        """Restore an ``export_state`` snapshot (this package's or the
        reference's) into this freshly opened session: the next
        ``adapt()`` / ``resize()`` continues from the restored labels as
        if this session had computed them.  The session's graph must
        already be at the snapshot's logical state; labels for a
        since-grown vertex set are extended by the usual -1 ->
        least-loaded rule on the next run.  Chainable."""
        self._check_open()
        labels = np.asarray(state["labels"], np.int32)
        if labels.shape[0] > self._graph.num_vertices:
            raise ValueError(
                f"snapshot has {labels.shape[0]} labels but the session "
                f"graph has {self._graph.num_vertices} vertices; rebuild "
                f"the graph at (or past) the snapshot watermark first")
        if int(state["k"]) != self.cfg.k:
            raise ValueError(
                f"snapshot was taken at k={int(state['k'])} but the "
                f"session is configured with k={self.cfg.k}; open with "
                f"the saved k and resize() afterwards")
        self._prev = labels
        self._last = None
        self._runs = int(state["runs"])
        self._delta_seq = int(state["delta_watermark"])
        self._staged = None
        self._dirty = None
        return self

    def stats(self) -> dict:
        """Session state: shape buckets, run and upload counters, padded
        layout and the delta fast-path counters.  Reads the BASE graph --
        pending fast-path deltas are reported under ``"delta"`` without
        forcing a host materialization."""
        self._check_open()
        graph, opts = self._graph, self.options
        padded, _ = _engine.padded_view(graph, opts)
        fs = self._delta
        d = {
            "num_vertices": graph.num_vertices,
            "num_directed_entries": graph.num_directed_entries,
            "k": self.cfg.k,
            "engine": opts.engine,
            "pad": opts.pad,
            "device": str(self._device),
            "bucket": (_engine.graph_buckets(graph)
                       if opts.pad == "bucket" else None),
            "padded_shape": (padded.num_vertices,
                             padded.num_directed_entries),
            "runs": self._runs,
            "uploads": self._uploads,
            "staged": (self._staged.num_vertices
                       if self._staged is not None else None),
            "delta": {
                "watermark": self._delta_seq,
                "pending_batches": len(self._pending),
                "merged_batches": fs.merged if fs is not None else 0,
                "fast_adapts": self._fast_adapts,
                "fallback_adapts": self._fallback_adapts,
                "host_rebuilds": self._host_rebuilds,
                "last_upload_bytes": self._delta_bytes_last,
                "upload_bytes_total": self._delta_bytes_total,
                "tracked_total_weight": (
                    fs.tracker.total_weight if fs is not None
                    else float(graph.total_weight)),
            },
            "score_backend": opts.backend().name,
            "fused_update": opts.resolved_fused_update(),
        }
        if self._last is not None:
            d["last"] = {"iterations": self._last.iterations,
                         "halted": self._last.halted,
                         "engine": self._last.engine,
                         "exchanged_bytes": self._last.exchanged_bytes,
                         "scored_vertices": self._last.scored_vertices,
                         "scored_per_iter": self._last.scored_per_iter}
        if self._mesh is not None:
            from ..launch.mesh import mesh_size
            from .distributed import comm_stats, shard_layout
            sg = shard_layout(padded, mesh_size(self._mesh, opts.axis),
                              pad=opts.pad == "bucket")
            d["exchange"] = comm_stats(sg, self.cfg, opts)
        return d

    # -- internals ---------------------------------------------------------

    def _require_prev(self, prev) -> np.ndarray:
        if prev is None:
            prev = self._prev
        if prev is None:
            raise ValueError("no previous labels in this session; run "
                             "partition() first or pass prev=")
        return np.asarray(prev, dtype=np.int32)

    def _run(self, init, record_history, callback,
             cfg: Optional[SpinnerConfig] = None) -> PartitionResult:
        self._check_open()
        graph, opts = self.graph, self.options
        cfg = self.cfg if cfg is None else cfg
        eng = opts.engine
        if eng == "auto":
            if self._mesh is not None:
                eng = "sharded"   # an explicit mesh implies the sharded runner
            else:
                eng = ("fused" if record_history is False and callback is None
                       else "chunked")
        if self._mesh is not None and eng != "sharded":
            raise ValueError(f"mesh= is only meaningful for engine='sharded', "
                             f"got {eng!r}")
        if eng not in _ENGINES:
            raise ValueError(f"unknown engine {eng!r}; "
                             f"available: {', '.join(_ENGINES)}")
        if eng in ("fused", "sharded"):
            remedy = ("per-iteration history/callbacks are not available "
                      "on a device mesh; run engine='chunked' without "
                      "mesh= for traces" if eng == "sharded"
                      else "use engine='chunked' (or 'auto') instead")
            if callback is not None:
                raise ValueError(f"engine={eng!r} cannot invoke a "
                                 f"per-iteration callback; {remedy}")
            if record_history is True:
                raise ValueError(f"engine={eng!r} cannot record "
                                 f"per-iteration history; {remedy}")

        labels, loads, key = prepare_init(graph, cfg, init,
                                          device=self._device)
        self._note_upload(graph)
        if eng == "host":
            res = self._run_host(cfg, labels, loads, key,
                                 record_history is not False, callback)
        else:
            if eng == "sharded":
                state = _engine.run_sharded(graph, cfg, labels, loads, key,
                                            mesh=self._mesh, axis=opts.axis,
                                            opts=opts)
                history = []
            elif eng == "fused":
                state = _engine.run_fused(graph, cfg, labels, loads, key,
                                          opts)
                history = []
            else:   # chunked
                record = record_history is not False
                state, history = _engine.run_chunked(
                    graph, cfg, labels, loads, key, opts,
                    chunk_size=opts.chunk_size or _engine.DEFAULT_CHUNK,
                    callback=callback, record=record)
                if not record:
                    history = []     # a callback forces recording
            # sharded labels come back padded to the sharded layout
            res = PartitionResult(
                labels=state.labels[:graph.num_vertices].cpu().numpy(),
                loads=state.loads.cpu().numpy(),
                iterations=int(state.iteration),
                halted=bool(state.halted), history=history,
                total_messages=float(state.total_messages), engine=eng,
                exchanged_bytes=float(state.exchanged_bytes))
        self._last = res
        self._prev = res.labels
        self._runs += 1
        self._dirty = None     # a full run reconverges every vertex
        return res

    def _run_host(self, cfg: SpinnerConfig, labels, loads, key: rng.Key,
                  record_history: bool, callback) -> PartitionResult:
        """Per-iteration host loop -- the other runners' oracle.

        Same padded layout and step as the chunk loop; the halting compare
        runs in numpy float32, matching the device's ``_halting_update``
        bit for bit.  ``cfg`` arrives from ``_run`` (resize runs the new k
        before committing it to the session).
        """
        graph = self.graph
        step = _engine.make_host_step(graph, cfg, self.options,
                                      labels.device)
        num_real = graph.num_vertices
        labels = _engine.pad_labels(labels, step.v_pad)
        best_score = np.float32(-np.inf)
        eps32 = np.float32(cfg.eps)
        stall = 0
        history: List[dict] = []
        halted = False
        total_messages = 0.0
        it = 0
        for it in range(1, cfg.max_iters + 1):
            key, k_it = rng.split(key)
            labels, loads, score_g, n_mig, mig_mass = step(labels, loads,
                                                           k_it)
            score_g = np.float32(score_g.item())
            total_messages += float(mig_mass)
            if record_history or callback is not None:
                lab_np = labels[:num_real].cpu().numpy()
                entry = {
                    "iteration": it,
                    "score": float(score_g),
                    "migrations": int(n_mig),
                    "message_mass": float(mig_mass),
                    "phi": metrics.phi(graph, lab_np),
                    "rho": metrics.rho(graph, lab_np, cfg.k),
                }
                if record_history:
                    history.append(entry)
                if callback is not None:
                    callback(it, entry)
            # on iteration 1 best_score is -inf, tol is inf and best + tol
            # is NaN: the compare is False (the invalid-op warning is
            # expected)
            with np.errstate(invalid="ignore"):
                tol = eps32 * np.maximum(np.float32(1.0), np.abs(best_score))
                improved = score_g > best_score + tol
            best_score = np.maximum(best_score, score_g)
            if improved:
                stall = 0
            else:
                stall += 1
                if stall >= cfg.halt_window:
                    halted = True
                    break
        return PartitionResult(labels=labels[:num_real].cpu().numpy(),
                               loads=loads.cpu().numpy(), iterations=it,
                               halted=halted, history=history,
                               total_messages=total_messages, engine="host")


def open_session(graph: Graph, cfg: SpinnerConfig,
                 options: Optional[EngineOptions] = None
                 ) -> PartitionSession:
    """Open a device-resident partitioning session."""
    return PartitionSession(graph, cfg, options)
