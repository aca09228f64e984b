"""Spinner LPA engine in PyTorch: one device, or SPMD over a mesh.

The pieces mirror the reference engine:

  * ``SpinnerState`` -- everything one iteration reads or writes: labels,
    loads, the threefry key (a pair of Python ints, the generator state),
    the Eq. 9 halting aggregates (best_score / stall), the iteration
    counter, the halted flag and the last step's migration statistics.
  * ``GraphBind`` -- the per-graph arguments: the padded graph's weighted
    degrees, the Eq. 5 capacity C, the real-vertex mask and the score
    backend's device arrays.
  * ``make_update_parts`` -- the iteration math (Eqs. 7-8, 11-12) in the
    reference's op order, so every backend and runner walks the
    reference's trajectory bit for bit (score(G) aside, whose float32 sum
    order differs).
  * the runners: ``run_fused`` / ``run_chunked`` share one chunk loop, and
    ``make_host_step`` is the per-iteration step of the host loop in
    ``session.py``.
  * frontier mode (``make_frontier_step`` / ``make_frontier_runner`` /
    ``run_frontier``): dirty-set reconvergence after a small edge delta --
    only ``real & active`` vertices are scored, the active set grows one
    hop per iteration along edges out of vertices that changed label, and
    the run halts when no active vertex wants to move.
  * the session's delta fast path: ``merge_delta`` (the on-device merge of
    an appended batch) and ``device_loads`` (loads from labels on the
    device).
  * the sharded runner (``make_sharded_runner`` / ``run_sharded``): the same
    iteration SPMD over a ``torch.distributed`` mesh
    (``repro_torch.launch.mesh``), one process per device, each holding
    its label shard and its edges (``core.distributed.rank_shard``).  A
    pluggable exchange plan (``core.comm``) turns the label shards into
    the lookup the edges read; the (k,) and scalar aggregates are summed
    over the ranks in rank order, so every rank takes the same halting
    decision and cuts its chunks at the same iteration.  Under
    ``overlap="on"`` a step is ``start_exchange -> score the interior
    segment -> finish_exchange -> score the frontier segment``, the
    collective in flight while the interior is scored; the result is the
    same bit for bit (integer Eq. 3 weights make every partial exact).
  * the sharded frontier runner (``make_sharded_frontier_step_fn`` /
    ``sharded_frontier_loop`` / ``run_sharded_frontier``): frontier mode
    on a mesh, the torch backend without overlap, as the reference pins
    its XLA backend; the active set grows along the diff of consecutive
    lookups, so it works in every plan's index space.

PyTorch has no device-side while loop, so the chunk loop syncs with the
host once per chunk and sizes each chunk so the run cannot halt before
the chunk's last step: ``stall`` rises by at most one per iteration, so a
run with ``stall`` s cannot halt within ``halt_window - s - 1`` steps.
No kernel is launched after the halt, and iteration counts equal the
reference's.  Inside the chunk the halting state is a device mask: a step
on a halted state passes it through unchanged, as the reference's guarded
scan does.  A frontier run can drain at any step, so its loop reads the
drained flag (with the step's scored count) once per iteration instead.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from .. import rng
from ..kernels import ops
from ..kernels.ref import propose_ref
from .graph import Graph, pad_graph, shape_bucket

DEFAULT_CHUNK = 32

# Shape-bucket floors: graphs below these sizes all share one bucket.
V_FLOOR = 64
E_FLOOR = 128


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card, and
    raises where there is none; a run never falls back to the CPU unless
    ``device="cpu"`` asks for it."""
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless "
                "device='cpu' (or EngineOptions(device='cpu')) asks for "
                "the CPU")
        return torch.device("cuda" if device is None else device)
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """How a run executes: runner, score backend, fused update, pad policy
    and device -- everything that is not a paper parameter.

    ``device=None`` means the CUDA card, and raises where there is none:
    a run never falls back to the CPU unless ``device="cpu"`` is asked
    for.  ``score_backend`` is ``"cuda"`` (the CSR kernels; their
    wrappers run the plain versions on CPU tensors) or ``"torch"`` (the
    scatter-add oracle).  ``fused_update="auto"`` turns the fused kernel
    on for backends that advertise ``fused_auto``.

    The sharded engine's knobs: ``mesh`` (a ``DeviceMesh`` from
    ``repro_torch.launch.mesh.make_partition_mesh``; ``None`` with
    ``engine="sharded"`` builds the default one) and its vertex ``axis``;
    ``label_exchange`` (``core.comm``'s plans: allgather, halo,
    halo_delta, delta; ``"auto"`` is allgather on one device and delta on
    more -- identical trajectories, decreasing wire bytes); ``delta_cap``
    (the delta plan's per-shard buffer, ``None`` = v_per_dev // 4);
    ``sharded_noise`` (``"replicated"`` draws a shard's rows of the
    whole padded draw, bit for bit the single-device streams; ``"folded"``
    folds the rank into the key and draws the shard alone); ``overlap``
    (``"on"`` scores the interior segment while the exchange is in
    flight, ``"auto"`` = on over more than one device; bit-identical to
    ``"off"``).
    """

    engine: str = "auto"             # auto | fused | chunked | sharded | host
    chunk_size: Optional[int] = None
    score_backend: Union[str, object] = "cuda"
    fused_update: str = "auto"       # auto | on | off
    pad: str = "bucket"              # bucket | none
    device: Optional[Union[str, torch.device]] = None
    mesh: object = None
    axis: str = "data"
    label_exchange: str = "auto"
    delta_cap: Optional[int] = None
    sharded_noise: str = "replicated"
    overlap: str = "auto"            # auto | on | off

    def __post_init__(self):
        self.resolved_overlap(1)     # an unknown schedule fails at once

    def resolved_label_exchange(self, ndev: int) -> str:
        from .comm import EXCHANGE_PLANS     # the one plan registry
        if self.label_exchange == "auto":
            return "allgather" if ndev == 1 else "delta"
        if self.label_exchange not in EXCHANGE_PLANS:
            raise ValueError(
                f"unknown label_exchange {self.label_exchange!r}; "
                f"available: auto, {', '.join(sorted(EXCHANGE_PLANS))}")
        return self.label_exchange

    def resolved_sharded_noise(self) -> str:
        if self.sharded_noise not in ("replicated", "folded"):
            raise ValueError(
                f"unknown sharded_noise {self.sharded_noise!r}; "
                "available: replicated, folded")
        return self.sharded_noise

    def resolved_overlap(self, ndev: int) -> str:
        if self.overlap == "auto":
            return "on" if ndev > 1 else "off"
        if self.overlap not in ("on", "off"):
            raise ValueError(f"unknown overlap {self.overlap!r}; "
                             "available: auto, on, off")
        return self.overlap

    def resolved_device(self) -> torch.device:
        return resolve_device(self.device)

    def resolved_fused_update(self) -> str:
        if self.fused_update not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused_update {self.fused_update!r}; "
                             "available: auto, on, off")
        if self.fused_update == "off":
            return "off"
        if self.fused_update == "auto":
            return "on" if getattr(self.backend(), "fused_auto",
                                   False) else "off"
        return "on"

    def backend(self):
        return ops.get_score_backend(self.score_backend)


# ---------------------------------------------------------------------------
# State and bind
# ---------------------------------------------------------------------------

class SpinnerState(NamedTuple):
    """Carry of the LPA loop; tensors on the run's device, key on the host."""

    labels: torch.Tensor         # (V,) int32 current assignment
    loads: torch.Tensor          # (k,) float32 B(l) (Eq. 6)
    key: rng.Key                 # threefry key consumed by one split per step
    best_score: torch.Tensor     # f32 scalar, best score(G) so far (Eq. 9)
    stall: torch.Tensor          # int32 scalar, non-improving iterations
    iteration: torch.Tensor      # int32 scalar, iterations completed
    halted: torch.Tensor         # bool scalar, eps/halt_window criterion fired
    total_messages: torch.Tensor  # f32 scalar, cumulative migrant degree mass
    score: torch.Tensor          # f32 scalar, score(G) after the last step
    migrations: torch.Tensor     # int32 scalar, migrants in the last step
    message_mass: torch.Tensor   # f32 scalar, migrant degree mass, last step
    exchanged_bytes: torch.Tensor  # f32 scalar, cumulative label-exchange
                                   # wire bytes (0 off the sharded engine)


def init_state(labels, loads, key: rng.Key, device=None) -> SpinnerState:
    labels = torch.as_tensor(labels, dtype=torch.int32, device=device)
    dev = labels.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return SpinnerState(
        labels=labels,
        loads=torch.as_tensor(loads, **f32),
        key=(int(key[0]), int(key[1])),
        best_score=torch.tensor(-np.inf, **f32),
        stall=torch.tensor(0, **i32),
        iteration=torch.tensor(0, **i32),
        halted=torch.tensor(False, device=dev),
        total_messages=torch.tensor(0.0, **f32),
        score=torch.tensor(0.0, **f32),
        migrations=torch.tensor(0, **i32),
        message_mass=torch.tensor(0.0, **f32),
        exchanged_bytes=torch.tensor(0.0, **f32),
    )


class GraphBind(NamedTuple):
    """Per-graph arguments of one run on the padded layout."""

    deg_w: torch.Tensor        # (V_pad,) f32 weighted degrees (0 on pads)
    capacity: torch.Tensor     # f32 scalar C (Eq. 5) of the REAL graph
    num_real: int              # vertices < num_real are real
    valid: torch.Tensor        # (V_pad,) bool, arange < num_real
    score: tuple               # score backend's device arrays
    hist: tuple = ()           # (src, dst, real_entry, ideal, real_e)
    frontier: tuple = ()       # ((src, dst), ...) expansion segments


def graph_buckets(graph: Graph) -> Tuple[int, int]:
    """(vertex bucket, edge bucket) the graph's padded shapes land in."""
    return (shape_bucket(graph.num_vertices, V_FLOOR),
            shape_bucket(graph.num_directed_entries, E_FLOOR))


def padded_view(graph: Graph, opts: EngineOptions) -> Tuple[Graph, int]:
    """(padded graph, real vertex count) under the options' pad policy;
    the padded view is cached on the graph."""
    if opts.pad == "none":
        return graph, graph.num_vertices
    if opts.pad != "bucket":
        raise ValueError(f"unknown pad policy {opts.pad!r}; "
                         "available: bucket, none")
    vb, eb = graph_buckets(graph)
    key = ("pad", vb, eb)
    padded = graph._cache.get(key)
    if padded is None:
        padded = graph._cache[key] = pad_graph(graph, vb, eb)
    return padded, graph.num_vertices


def pad_labels(labels: torch.Tensor, v_pad: int) -> torch.Tensor:
    """Extend labels to a padded vertex count (pads land on partition 0;
    they are masked out of every aggregate and never migrate)."""
    pad = v_pad - labels.shape[0]
    if pad:
        labels = torch.cat([labels, labels.new_zeros(pad)])
    return labels


def make_bind(graph: Graph, cfg, opts: EngineOptions, device,
              hist: bool = False, frontier: bool = False
              ) -> Tuple[GraphBind, Graph]:
    """The bind of one run: the padded graph's arrays on ``device``.

    With ``frontier`` the padded COO (the shared upload) is the expansion
    index: pad entries are weight-0 self-loops on pad vertices, which never
    change label, so they activate nothing."""
    padded, num_real = padded_view(graph, opts)
    csr = padded.to_device(device)
    backend = opts.backend()
    fused = opts.resolved_fused_update() == "on"
    score = (backend.fused_graph_args if fused else backend.graph_args)(csr)
    if hist and graph.src.size:
        hist_args = (csr.src.long(), csr.dst.long(), csr.weight > 0,
                     torch.tensor(graph.total_weight / cfg.k,
                                  dtype=torch.float32, device=device),
                     torch.tensor(graph.num_directed_entries,
                                  dtype=torch.float32, device=device))
    else:
        hist_args = ()
    v_pad = padded.num_vertices
    return GraphBind(
        deg_w=csr.deg_w,
        capacity=torch.tensor(cfg.capacity(graph), dtype=torch.float32,
                              device=device),
        num_real=num_real,
        valid=torch.arange(v_pad, device=device) < num_real,
        score=score, hist=hist_args,
        frontier=((csr.src, csr.dst),) if frontier else ()), padded


# ---------------------------------------------------------------------------
# The iteration math (shared by every runner and backend)
# ---------------------------------------------------------------------------

def make_update_parts(k: int, *, degree_weighted: bool,
                      current_bonus: float) -> Tuple[Callable, Callable]:
    """The vertex update split at its one global synchronisation point.

    ``propose(scores, labels, deg_w, loads, noise, valid, C)`` is the
    per-vertex half (Eq. 7-8) returning ``(best, tot_best, tot_cur,
    m_partial)``; the fused kernel computes the same four outputs from
    the CSR.  ``finish(best, tot_best, tot_cur, m_partial, labels, deg_w,
    loads, u, valid, C)`` is the Eq. 11-12 epilogue returning
    ``(new_labels, new_loads, score_g, n_mig, mig_mass)``.  ``C`` is a
    float32 device scalar: dividing by a host scalar would let PyTorch
    multiply by its reciprocal instead, which rounds differently.

    ``reduce_`` sums a list of tensors over the shards of a sharded run
    (the reference's ``psum``; see ``make_rank_sum``): once for M(l), once
    for the load delta and the three aggregates.  ``None`` at one device.
    """

    def propose(scores, labels, deg_w, loads, noise, valid, C):
        return propose_ref(scores, labels, deg_w, loads / C, noise, valid,
                           k, current_bonus, degree_weighted)

    def finish(best, tot_best, tot_cur, m_partial, labels, deg_w, loads,
               u, valid, C, reduce_=None):
        red = reduce_ if reduce_ is not None else (lambda parts: parts)
        want = (best != labels) & valid
        # ---- ComputeMigrations (Eq. 11-12) -----------------------------
        M, = red([m_partial])                                     # aggregator
        R = torch.clamp(C - loads, min=0.0)                       # Eq. 11
        p = torch.clamp(R / torch.clamp(M, min=1e-9), 0.0, 1.0)
        migrate = want & (u < p[best.long()])                     # Eq. 12
        new_labels = torch.where(migrate, best, labels)
        mig_deg = torch.where(migrate, deg_w, 0.0)
        delta = torch.zeros(k, dtype=torch.float32, device=loads.device)
        delta.index_add_(0, best.long(), mig_deg)
        delta.index_add_(0, labels.long(), -mig_deg)
        # ---- halting aggregate: score(G) at the new assignment (Eq. 9) --
        sel = torch.where(valid, torch.where(migrate, tot_best, tot_cur),
                          0.0)
        delta, score_g, n_mig, mig_mass = red(                    # aggregators
            [delta, sel.sum(), migrate.sum().to(torch.int32), mig_deg.sum()])
        new_loads = loads + delta
        return new_labels, new_loads, score_g, n_mig, mig_mass

    return propose, finish


def make_vertex_update(cfg) -> Callable:
    """``update(scores, labels, deg_w, loads, noise, u, valid, C,
    reduce_=None)``: the two halves composed, for the split (dense scores)
    path."""
    propose, finish = make_update_parts(
        cfg.k, degree_weighted=cfg.migration_weighting == "edges",
        current_bonus=cfg.current_bonus)

    def update(scores, labels, deg_w, loads, noise, u, valid, C,
               reduce_=None):
        parts = propose(scores, labels, deg_w, loads, noise, valid, C)
        return finish(*parts, labels, deg_w, loads, u, valid, C, reduce_)

    return update


def _halting_update(best_score, stall, score_g, eps: float,
                    halt_window: int):
    """Section 3.3 stall logic on the device.

    On the first iteration best_score is -inf, so tol is inf and
    ``best + tol`` is NaN: the comparison is False and the iteration
    counts toward the stall window, exactly as in the reference.
    """
    tol = torch.clamp(best_score.abs(), min=1.0) * eps
    improved = score_g > best_score + tol
    new_best = torch.maximum(best_score, score_g)
    new_stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
    return new_best, new_stall, new_stall >= halt_window


def make_iterate(cfg, opts: EngineOptions) -> Callable:
    """``iterate(labels, loads, key, bind) -> (labels, loads, score_g,
    n_mig, mig_mass)``: one LPA iteration on the padded layout.

    Noise and ``u`` are drawn over the padded vertex set from the same
    threefry streams as the reference (``split`` into noise and migration
    keys, then ``uniform``).
    """
    k, tie = cfg.k, cfg.tie_noise
    backend = opts.backend()
    if opts.resolved_fused_update() == "on":
        fused = backend.make_fused_update(
            k, degree_weighted=cfg.migration_weighting == "edges",
            current_bonus=float(cfg.current_bonus))
        scores_fn = update = None
    else:
        fused = None
        scores_fn = backend.make_scores(k)
        update = make_vertex_update(cfg)

    def iterate(labels, loads, key, bind: GraphBind):
        v_pad, dev = labels.shape[0], labels.device
        k_noise, k_mig = rng.split(key)
        noise = rng.uniform(k_noise, (v_pad, k), 0.0, tie, device=dev)
        u = rng.uniform(k_mig, (v_pad,), device=dev)
        if fused is not None:
            return fused(labels, loads, noise, u, bind)
        scores = scores_fn(labels, *bind.score)
        return update(scores, labels, bind.deg_w, loads, noise, u,
                      bind.valid, bind.capacity)

    return iterate


def make_step(cfg, opts: EngineOptions) -> Callable:
    """``step(state, bind) -> state``: one guarded state transition.

    On a halted (or ``max_iters``) state the device tensors pass through
    unchanged; the key, held on the host, still advances, so the runners
    never step such a state (their chunks end at the first possible halt).
    """
    iterate = make_iterate(cfg, opts)
    halt_window, max_iters = cfg.halt_window, cfg.max_iters
    eps = float(np.float32(cfg.eps))

    def step(state: SpinnerState, bind: GraphBind) -> SpinnerState:
        key, k_it = rng.split(state.key)
        out = iterate(state.labels, state.loads, k_it, bind)
        return _advance(state, key, *out, eps, halt_window, max_iters)

    return step


def _advance(state: SpinnerState, key: rng.Key, labels, loads, score_g,
             n_mig, mig_mass, eps: float, halt_window: int, max_iters: int,
             xbytes=None) -> SpinnerState:
    """The state after one iteration's outputs, with the halting update;
    guarded: on a halted (or ``max_iters``) state the device tensors pass
    through unchanged.  ``xbytes`` is the step's label-exchange wire
    bytes (sharded runs)."""
    best, stall, halted = _halting_update(
        state.best_score, state.stall, score_g, eps, halt_window)
    active = ~state.halted & (state.iteration < max_iters)

    def keep(new, old):
        return torch.where(active, new, old)

    exchanged = state.exchanged_bytes
    if xbytes is not None:
        exchanged = keep(exchanged + xbytes, exchanged)
    return SpinnerState(
        labels=keep(labels, state.labels),
        loads=keep(loads, state.loads),
        key=key,
        best_score=keep(best, state.best_score),
        stall=keep(stall, state.stall),
        iteration=keep(state.iteration + 1, state.iteration),
        halted=keep(halted, state.halted),
        total_messages=keep(state.total_messages + mig_mass,
                            state.total_messages),
        score=keep(score_g, state.score),
        migrations=keep(n_mig, state.migrations),
        message_mass=keep(mig_mass, state.message_mass),
        exchanged_bytes=exchanged)


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------

def _record(state: SpinnerState, bind: GraphBind) -> dict:
    """One history entry, on the device (read back once per chunk)."""
    if bind.hist:
        src, dst, real, ideal, real_e = bind.hist
        # count only real edges: pads are weight-0 self-loops
        local = (state.labels[src] == state.labels[dst]) & real
        phi = local.to(torch.float32).sum() / real_e
        rho = state.loads.max() / ideal
    else:
        # edgeless graph: metrics.rho's ideal <= 0 convention
        phi = rho = torch.tensor(1.0, device=state.loads.device)
    return {"iteration": state.iteration, "score": state.score,
            "migrations": state.migrations,
            "message_mass": state.message_mass, "phi": phi, "rho": rho}


_RECORD_TYPES = {"iteration": int, "score": float, "migrations": int,
                 "message_mass": float, "phi": float, "rho": float}


def _state_device(state: SpinnerState, opts: EngineOptions) -> torch.device:
    """The options' device, which the state's tensors must already be on:
    a runner never moves a run to another device than the one asked for."""
    want = opts.resolved_device()
    for name in ("labels", "loads"):
        got = getattr(state, name).device
        if got.type != want.type or (want.index is not None
                                     and got.index != want.index):
            raise ValueError(f"state.{name} is on {got}, but the options ask "
                             f"for {want}: build the state with "
                             f"init_state(..., device={str(want)!r})")
    return state.labels.device


def _chunk_loop(cfg, state: SpinnerState, advance: Callable,
                chunk_size: int, record: Optional[Callable] = None,
                callback: Optional[Callable] = None
                ) -> Tuple[SpinnerState, List[dict]]:
    """The chunk loop: ``advance(state) -> state`` steps a PADDED state.

    Each chunk is at most ``chunk_size`` steps, cut short so that the run
    can only halt at the chunk's last step (see the module docstring);
    the host reads the halting state once per chunk and, with ``record``
    (``record(state) -> entry`` on the device), the chunk's history.
    """
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    history: List[dict] = []
    while True:
        halted, stall, it = torch.stack(
            [state.halted.to(torch.int64), state.stall.to(torch.int64),
             state.iteration.to(torch.int64)]).tolist()
        if halted or it >= cfg.max_iters:
            break
        n = max(1, min(chunk_size, cfg.max_iters - it,
                       cfg.halt_window - stall))
        recs = []
        for _ in range(n):
            state = advance(state)
            if record is not None:
                recs.append(record(state))
        if recs:
            cols = {f: torch.stack([r[f].to(torch.float64) for r in recs])
                    .tolist() for f in _RECORD_TYPES}
            for i in range(len(recs)):
                entry = {f: cast(cols[f][i])
                         for f, cast in _RECORD_TYPES.items()}
                history.append(entry)
                if callback is not None:
                    callback(entry["iteration"], entry)
    return state, history


def _run_chunks(graph: Graph, cfg, state: SpinnerState, opts: EngineOptions,
                chunk_size: int, record: bool,
                callback: Optional[Callable] = None
                ) -> Tuple[SpinnerState, List[dict]]:
    """The chunk loop behind ``run_fused`` and ``run_chunked``: ``state``
    covers the real vertices; it is padded in and sliced out."""
    dev = _state_device(state, opts)
    bind, padded = make_bind(graph, cfg, opts, dev, hist=record)
    state = state._replace(labels=pad_labels(state.labels,
                                             padded.num_vertices))
    step = make_step(cfg, opts)
    state, history = _chunk_loop(
        cfg, state, lambda s: step(s, bind), chunk_size,
        (lambda s: _record(s, bind)) if record else None, callback)
    return state._replace(labels=state.labels[:graph.num_vertices]), history


def run_bound(cfg, opts: EngineOptions, state: SpinnerState,
              bind: GraphBind) -> SpinnerState:
    """Run a PADDED state to the stable state on a given bind (the
    session's fast path, whose bind holds the merged delta), no history."""
    step = make_step(cfg, opts)
    return _chunk_loop(cfg, state, lambda s: step(s, bind),
                       opts.chunk_size or DEFAULT_CHUNK)[0]


def make_fused_runner(graph: Graph, cfg, opts: EngineOptions) -> Callable:
    """``runner(state) -> state``: run to the stable state, no history.

    Accepts a state over the REAL vertex set (fresh from ``init_state``
    or carried over from a reference run by ``repro_torch.convert``) on
    the options' device; a state elsewhere raises.
    """
    chunk = opts.chunk_size or DEFAULT_CHUNK
    opts.resolved_device()          # no card and no device="cpu": raise now

    def runner(state: SpinnerState) -> SpinnerState:
        return _run_chunks(graph, cfg, state, opts, chunk, record=False)[0]

    return runner


def run_fused(graph: Graph, cfg, labels, loads, key: rng.Key,
              opts: EngineOptions) -> SpinnerState:
    """Run to the stable state, syncing with the host once per chunk, on
    the options' device (host arrays are uploaded there)."""
    return make_fused_runner(graph, cfg, opts)(
        init_state(labels, loads, key, device=opts.resolved_device()))


def run_chunked(graph: Graph, cfg, labels, loads, key: rng.Key,
                opts: EngineOptions, chunk_size: int = DEFAULT_CHUNK,
                callback: Optional[Callable] = None, record: bool = True
                ) -> Tuple[SpinnerState, List[dict]]:
    """Run recording the per-iteration history (iteration / score /
    migrations / message_mass / phi / rho), read back once per chunk.
    A ``callback`` forces recording on.  Runs on the options' device."""
    record = record or callback is not None
    state = init_state(labels, loads, key, device=opts.resolved_device())
    return _run_chunks(graph, cfg, state, opts, chunk_size, record, callback)


def make_host_step(graph: Graph, cfg, opts: EngineOptions,
                   device) -> Callable:
    """``step(labels, loads, key)`` on the options' padded layout, for the
    per-iteration host loop.  Labels are carried PADDED between calls;
    ``step.v_pad`` is the padded vertex count."""
    bind, padded = make_bind(graph, cfg, opts, device)
    iterate = make_iterate(cfg, opts)

    def step(labels, loads, key):
        return iterate(labels, loads, key, bind)

    step.v_pad = padded.num_vertices
    return step


# ---------------------------------------------------------------------------
# Frontier mode: dirty-set LPA reconvergence
# ---------------------------------------------------------------------------
# After a small edge delta on a converged partition, only the endpoints of
# changed edges can want to move, and migrations propagate label changes
# one hop per iteration.  A frontier step scores only the ACTIVE vertex set
# (valid &= active), expands it along edges out of vertices that changed
# label, and the run halts when no active vertex wants to move.  Inactive
# vertices keep their labels and add nothing to any aggregate; the CUDA
# backend launches the fused kernel's frontier variant, whose inactive
# rows skip their edges and noise.  Noise and u are still drawn over the
# whole padded vertex set, so on a converged base the frontier trajectory
# replays the reference's bit for bit.

def frontier_touched(changed: torch.Tensor, segments: tuple,
                     rows: Optional[int] = None) -> torch.Tensor:
    """Vertices with an edge to a vertex that changed label, over every
    ``(src, dst)`` segment (the base COO and the delta).  ``rows`` is the
    number of source rows when ``dst`` indexes another space than ``src``
    (a shard's rows against the exchange plan's lookup)."""
    hits = torch.zeros(changed.shape[0] if rows is None else rows,
                       dtype=torch.int32, device=changed.device)
    for src, dst in segments:
        hits.index_add_(0, src, changed.index_select(0, dst).to(torch.int32))
    return hits > 0


def make_frontier_step(cfg, opts: EngineOptions) -> Callable:
    """``step(state, active, bind) -> (state, active, scored)``: one
    frontier iteration.

    The update math is ``make_step``'s with ``valid`` additionally masked
    by ``active``; the state's ``halted`` is the drain (no active vertex
    wants to move), ``stall``/``best_score`` advance as in a dense step;
    the next active set is ``want | touched``.  ``scored`` is the f32
    device count of ``valid & active``.
    """
    k, tie = cfg.k, cfg.tie_noise
    eps = float(np.float32(cfg.eps))
    backend = opts.backend()
    if opts.resolved_fused_update() == "on":
        fused = backend.make_fused_update(
            k, degree_weighted=cfg.migration_weighting == "edges",
            current_bonus=float(cfg.current_bonus), frontier=True)
        scores_fn = propose = finish = None
    else:
        fused = None
        scores_fn = backend.make_scores(k)
        propose, finish = make_update_parts(
            k, degree_weighted=cfg.migration_weighting == "edges",
            current_bonus=cfg.current_bonus)

    def step(state: SpinnerState, active: torch.Tensor, bind: GraphBind):
        key, k_it = rng.split(state.key)
        v_pad, dev = state.labels.shape[0], state.labels.device
        k_noise, k_mig = rng.split(k_it)
        noise = rng.uniform(k_noise, (v_pad, k), 0.0, tie, device=dev)
        u = rng.uniform(k_mig, (v_pad,), device=dev)
        fbind = bind._replace(valid=bind.valid & active)
        valid = fbind.valid
        if fused is not None:
            labels, loads, score_g, n_mig, mig_mass, want = fused(
                state.labels, state.loads, noise, u, fbind)
        else:
            scores = scores_fn(state.labels, *bind.score)
            parts = propose(scores, state.labels, bind.deg_w, state.loads,
                            noise, valid, bind.capacity)
            want = (parts[0] != state.labels) & valid
            labels, loads, score_g, n_mig, mig_mass = finish(
                *parts, state.labels, bind.deg_w, state.loads, u, valid,
                bind.capacity)
        touched = frontier_touched(labels != state.labels, bind.frontier)
        best, stall, _ = _halting_update(
            state.best_score, state.stall, score_g, eps, cfg.halt_window)
        new_state = SpinnerState(
            labels=labels, loads=loads, key=key, best_score=best,
            stall=stall, iteration=state.iteration + 1,
            halted=~want.any(),
            total_messages=state.total_messages + mig_mass, score=score_g,
            migrations=n_mig, message_mass=mig_mass,
            exchanged_bytes=state.exchanged_bytes)
        return new_state, want | touched, valid.to(torch.float32).sum()

    return step


def frontier_loop(cfg, opts: EngineOptions, state: SpinnerState,
                  active: torch.Tensor, bind: GraphBind
                  ) -> Tuple[SpinnerState, List[float]]:
    """Run a PADDED state in frontier mode until it drains (or reaches
    ``max_iters``); returns ``(state, scored_per_iteration)``.

    The host reads the drained flag and the step's scored count once per
    iteration, so nothing is launched after the drain: launches equal
    iterations.
    """
    step = make_frontier_step(cfg, opts)
    carry = [active]

    def advance(s: SpinnerState):
        s, carry[0], count = step(s, carry[0], bind)
        return s, count

    return _drain_loop(cfg, state, advance)


def _drain_loop(cfg, state: SpinnerState, advance: Callable
                ) -> Tuple[SpinnerState, List[float]]:
    """Step ``advance(state) -> (state, scored)`` until the state drains
    or reaches ``max_iters``, reading the drained flag and the scored
    count on the host once per iteration."""
    halted, it = torch.stack([state.halted.to(torch.int64),
                              state.iteration.to(torch.int64)]).tolist()
    scored: List[float] = []
    while not halted and it < cfg.max_iters:
        state, count = advance(state)
        drained, count = torch.stack(
            [state.halted.to(torch.float32), count]).tolist()
        scored.append(count)
        halted, it = bool(drained), it + 1
    return state, scored


def _pad_active(active, v_pad: int, device) -> torch.Tensor:
    """An active mask over the real vertices, padded with False."""
    active = torch.as_tensor(np.asarray(active, bool)).to(device)
    pad = v_pad - active.shape[0]
    if pad:
        active = torch.cat([active, active.new_zeros(pad)])
    return active


def make_frontier_runner(graph: Graph, cfg, opts: EngineOptions) -> Callable:
    """``runner(state, active) -> (state, scored_per_iteration)`` over the
    padded layout; accepts a state and an active mask over the REAL
    vertex set, on the options' device."""
    opts.resolved_device()          # no card and no device="cpu": raise now

    def runner(state: SpinnerState, active):
        dev = _state_device(state, opts)
        bind, padded = make_bind(graph, cfg, opts, dev, frontier=True)
        v_pad = padded.num_vertices
        state = state._replace(labels=pad_labels(state.labels, v_pad))
        out, scored = frontier_loop(cfg, opts, state,
                                    _pad_active(active, v_pad, dev), bind)
        return out._replace(labels=out.labels[:graph.num_vertices]), scored

    return runner


def run_frontier(graph: Graph, cfg, labels, loads, key: rng.Key, active,
                 opts: EngineOptions) -> Tuple[SpinnerState, List[float]]:
    """Frontier-mode run to drain on the options' device:
    ``(state, scored_per_iteration)``."""
    return make_frontier_runner(graph, cfg, opts)(
        init_state(labels, loads, key, device=opts.resolved_device()),
        active)


# ---------------------------------------------------------------------------
# The session's delta fast path: on-device merge and loads
# ---------------------------------------------------------------------------

def merge_delta(segment: tuple, new: tuple, deg_w: torch.Tensor) -> tuple:
    """Append a batch to the delta segment on the device.

    ``segment`` and ``new`` are ``(src int32, dst int32, w f32)`` triples;
    the merged entries are re-sorted by source (stable, so each row keeps
    arrival order) and the segment's ``(V_pad + 1,)`` row pointer rebuilt:
    O(segment + V) device work.  ``deg_w`` gains each new entry's weight
    at its source (integer sums, exact), out of place: the old degrees
    stay as they were.  Returns ``(src, dst, w, row_ptr, deg_w)``.
    """
    src, dst, w = (torch.cat([a, b]) for a, b in zip(segment, new))
    order = torch.sort(src, stable=True).indices
    src, dst, w = src[order], dst[order], w[order]
    v_pad = deg_w.shape[0]
    row_ptr = torch.zeros(v_pad + 1, dtype=torch.int64, device=deg_w.device)
    torch.cumsum(torch.bincount(src, minlength=v_pad), 0, out=row_ptr[1:])
    return src, dst, w, row_ptr, deg_w.index_add(0, new[0], new[2])


def device_loads(labels: torch.Tensor, deg_w: torch.Tensor,
                 k: int) -> torch.Tensor:
    """B(l) (Eq. 6) from padded labels and degrees on the device: pads
    carry zero degree, and the integer-valued float32 degrees make the
    sum exact in any order, so it equals ``spinner.compute_loads``."""
    loads = torch.zeros(k, dtype=torch.float32, device=deg_w.device)
    return loads.index_add_(0, labels.long(), deg_w)


# ---------------------------------------------------------------------------
# Batched same-bucket runs (the serving tier's executor)
# ---------------------------------------------------------------------------
# The reference stacks same-shaped (state, bind) pytrees and runs one vmap'd
# while_loop.  Here a key is a host tuple and a session's delta segment has
# its own length, so nothing stacks leaf for leaf: a batch stacks each
# element's device tensors along a leading dimension, draws every element's
# noise from its own key in one pass (``rng.uniform_many``) and concatenates
# the torch backend's edge entries, base then delta, with the row offset
# ``b * V_pad`` into one scatter over an ``(nb * V_pad, k)`` matrix.  The
# Eq. 3 weights make every score sum exact, so the order does not matter.

def _static_cfg(cfg) -> tuple:
    """The paper parameters a run's iteration math depends on.  ``seed``
    feeds only the host key and ``c`` only the capacity, which each
    element's bind carries, so seed and slack sweeps share a batch."""
    return (cfg.k, float(cfg.eps), cfg.halt_window, cfg.max_iters,
            cfg.migration_weighting, float(cfg.tie_noise),
            float(cfg.current_bonus))


def backend_signature(backend) -> tuple:
    """A score backend's batching identity (the reference backends'
    ``signature()``): its class and name."""
    return (type(backend).__name__, getattr(backend, "name", None))


def batch_bucket(n: int) -> int:
    """Power-of-two batch-size bucket (1, 2, 4, 8, ...): the reference
    pads a batch to it so a wobbling fleet reuses one compiled program.
    Eager PyTorch compiles nothing per batch size, so ``run_batched`` runs
    only the real elements; the scheduler still reports occupancy as
    ``n / batch_bucket(n)``, as the reference does."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def batch_signature(cfg, opts: EngineOptions, bind: GraphBind) -> tuple:
    """Batchability key of a ``(cfg, opts, bind)`` work item: the static
    config, the backend signature, the fused flag and the padded
    ``(V_pad, E_pad)`` -- what ``PartitionSession.batch_key`` keys on.
    The delta segment's length is not part of it: the batch concatenates
    each element's entries, so warm tenants with deltas of different
    lengths share a batch."""
    return (_static_cfg(cfg), backend_signature(opts.backend()),
            opts.resolved_fused_update() == "on",
            int(bind.deg_w.shape[0]), int(bind.score[0].shape[0]))


class BatchBind(NamedTuple):
    """The binds of a batch's elements, for one scatter over ``(nb *
    V_pad, k)``: per-element tensors stacked, edge entries concatenated
    with their rows offset by ``b * V_pad``."""

    deg_w: torch.Tensor        # (nb, V_pad) f32
    capacity: torch.Tensor     # (nb,) f32
    valid: torch.Tensor        # (nb, V_pad) bool
    src: torch.Tensor          # (entries,) int64 rows of the (nb*V_pad, k)
    dst: torch.Tensor          # (entries,) int64 into the flat labels
    w: torch.Tensor            # (entries,) f32


def stack_states(states: Sequence[SpinnerState]) -> SpinnerState:
    """Stack states along a new leading dimension; the ``key`` field
    becomes the tuple of the elements' host keys."""
    fields = {f: torch.stack([getattr(s, f) for s in states])
              for f in SpinnerState._fields if f != "key"}
    return SpinnerState(key=tuple(s.key for s in states), **fields)


def index_state(states: SpinnerState, i: int) -> SpinnerState:
    """Element ``i`` of a stacked batch of states."""
    return SpinnerState(*(x[i] for x in states))


def stack_binds(binds: Sequence[GraphBind]) -> BatchBind:
    """The ``BatchBind`` of same-signature torch-backend binds: each
    bind's ``score`` holds ``(src, dst, w)`` triples (the base segment,
    then the merged delta if there is one)."""
    v_pad = binds[0].deg_w.shape[0]
    src, dst, w = [], [], []
    for b, bind in enumerate(binds):
        off = b * v_pad
        for i in range(0, len(bind.score), 3):
            s, d, we = bind.score[i:i + 3]
            src.append(s.long() + off)
            dst.append(d.long() + off)
            w.append(we)
    return BatchBind(
        deg_w=torch.stack([b.deg_w for b in binds]),
        capacity=torch.stack([b.capacity for b in binds]),
        valid=torch.stack([b.valid for b in binds]),
        src=torch.cat(src), dst=torch.cat(dst), w=torch.cat(w))


def batched_draws(cfg, keys: torch.Tensor, v_pad: int) -> tuple:
    """``(noise, u)`` of one batched iteration: ``keys`` is the ``(nb, 2,
    2)`` int64 tensor of each element's (noise, migration) key words."""
    dev = keys.device
    noise = rng.uniform_many(keys[:, 0], (v_pad, cfg.k), 0.0, cfg.tie_noise,
                             device=dev)
    return noise, rng.uniform_many(keys[:, 1], (v_pad,), device=dev)


def batched_scores(labels: torch.Tensor, bind: BatchBind,
                   k: int) -> torch.Tensor:
    """ComputeScores of every element as one scatter: ``(nb, V_pad, k)``."""
    nb, v_pad = labels.shape
    out = torch.zeros((nb * v_pad, k), dtype=torch.float32,
                      device=labels.device)
    out.index_put_((bind.src, labels.reshape(-1)[bind.dst].long()), bind.w,
                   accumulate=True)
    return out.view(nb, v_pad, k)


def batched_update(cfg, scores, labels, loads, noise, u,
                   bind: BatchBind) -> tuple:
    """``make_update_parts``' propose and finish over a batch, op for op.

    Elementwise work runs on the stacked tensors, which gives each
    element the bits of its own run.  M(l) and the load delta are
    ``index_add_`` over ``(nb * k)`` buckets of degree values (exact in
    any order on the Eq. 3 weights, as in every backend); score(G) and
    the migrant mass are float sums taken per element, each over its own
    ``(V_pad,)`` row exactly as the unbatched ``finish`` takes them.
    Returns ``(labels, loads, score_g, n_mig, mig_mass)``, each ``(nb,
    ...)``."""
    nb, k = labels.shape[0], cfg.k
    dev = labels.device
    C = bind.capacity[:, None]
    # ---- propose (Eq. 7-8), as kernels.ref.propose_ref ------------------
    norm = scores / torch.clamp(bind.deg_w, min=1.0)[:, :, None]
    total = norm - (loads / C)[:, None, :]
    bonus = torch.nn.functional.one_hot(labels.long(), k).to(
        torch.float32) * float(np.float32(cfg.current_bonus))
    best = torch.argmax(total + noise + bonus, dim=2).to(torch.int32)
    want = (best != labels) & bind.valid
    measure = (bind.deg_w if cfg.migration_weighting == "edges"
               else torch.ones_like(bind.deg_w))
    off = (torch.arange(nb, device=dev) * k)[:, None]
    best_k, cur_k = (best.long() + off).reshape(-1), \
        (labels.long() + off).reshape(-1)
    M = torch.zeros(nb * k, dtype=torch.float32, device=dev).index_add_(
        0, best_k, torch.where(want, measure, 0.0).reshape(-1)).view(nb, k)
    tot_best = total.gather(2, best.long()[..., None])[..., 0]
    tot_cur = total.gather(2, labels.long()[..., None])[..., 0]
    # ---- finish (Eq. 11-12), as make_update_parts' ----------------------
    R = torch.clamp(C - loads, min=0.0)
    p = torch.clamp(R / torch.clamp(M, min=1e-9), 0.0, 1.0)
    migrate = want & (u < p.gather(1, best.long()))
    new_labels = torch.where(migrate, best, labels)
    mig_deg = torch.where(migrate, bind.deg_w, 0.0)
    delta = torch.zeros(nb * k, dtype=torch.float32, device=dev)
    delta.index_add_(0, best_k, mig_deg.reshape(-1))
    delta.index_add_(0, cur_k, -mig_deg.reshape(-1))
    sel = torch.where(bind.valid, torch.where(migrate, tot_best, tot_cur),
                      0.0)
    score_g = torch.stack([row.sum() for row in sel])
    mig_mass = torch.stack([row.sum() for row in mig_deg])
    n_mig = migrate.sum(dim=1).to(torch.int32)
    return (new_labels, loads + delta.view(nb, k), score_g, n_mig,
            mig_mass)


def _batched_step(cfg, state: SpinnerState, keys: torch.Tensor,
                  bind: BatchBind) -> SpinnerState:
    """One iteration of every element of a stacked state (all active)."""
    v_pad = state.labels.shape[1]
    noise, u = batched_draws(cfg, keys, v_pad)
    scores = batched_scores(state.labels, bind, cfg.k)
    labels, loads, score_g, n_mig, mig_mass = batched_update(
        cfg, scores, state.labels, state.loads, noise, u, bind)
    best, stall, halted = _halting_update(
        state.best_score, state.stall, score_g, float(np.float32(cfg.eps)),
        cfg.halt_window)
    return state._replace(
        labels=labels, loads=loads, best_score=best, stall=stall,
        iteration=state.iteration + 1, halted=halted,
        total_messages=state.total_messages + mig_mass, score=score_g,
        migrations=n_mig, message_mass=mig_mass)


def chunk_keys(keys: list, active: Sequence[int], n: int, device
               ) -> torch.Tensor:
    """Advance the active elements' host keys by ``n`` iterations (in
    place in ``keys``) and return the ``(n, len(active), 2, 2)`` int64
    tensor of each iteration's (noise, migration) keys, uploaded once."""
    words = np.empty((n, len(active), 2, 2), np.int64)
    for j, b in enumerate(active):
        key = keys[b]
        for s in range(n):
            key, k_it = rng.split(key)
            words[s, j] = rng.split(k_it)
        keys[b] = key
    return torch.from_numpy(words).to(device)


def run_batched(items: Sequence[Tuple[SpinnerState, GraphBind]], cfg,
                opts: Optional[EngineOptions] = None,
                on_program: Optional[Callable] = None
                ) -> List[SpinnerState]:
    """Run independent same-signature ``(state, bind)`` work items of the
    torch scatter backend as one batch; returns each item's final state,
    bit-identical to its own ``run_bound`` (its host key included).

    States arrive and leave PADDED (``PartitionSession.adapt_parts`` /
    ``commit_adapt`` pad and slice).  Only the real elements run: there
    are no pad lanes (see ``batch_bucket``).  The host reads every
    element's halting state once per chunk and sizes the chunk as the
    minimum over the active elements of ``min(chunk, max_iters - it,
    halt_window - stall)``, so no element can halt inside a chunk; a
    frozen element is left out of the next chunk, its state and key
    unchanged.  ``on_program``, if given, is called once with the batch's
    signature (the reference passes its compiled program; nothing
    compiles here).  The CUDA backend's tenants run serially through
    their own kernel path instead (``PartitionSession.batchable``).
    """
    if not items:
        return []
    opts = opts if opts is not None else EngineOptions()
    if getattr(opts.backend(), "name", None) != "torch":
        raise ValueError("run_batched batches the 'torch' scatter backend; "
                         "run other backends' items through run_bound")
    sigs = {batch_signature(cfg, opts, b) for _, b in items}
    if len(sigs) != 1:
        raise ValueError(f"items do not share one batch_signature: {sigs}")
    for s, _ in items:
        _state_device(s, opts)
    if on_program is not None:
        on_program(next(iter(sigs)))
    binds = [b for _, b in items]
    keys = [s.key for s, _ in items]
    state = stack_states([s for s, _ in items])
    dev = state.labels.device
    chunk = opts.chunk_size or DEFAULT_CHUNK
    bound_for, bind = None, None
    while True:
        flags = torch.stack([state.halted.to(torch.int64),
                             state.stall.to(torch.int64),
                             state.iteration.to(torch.int64)], 1).tolist()
        active = [b for b, (h, _, it) in enumerate(flags)
                  if not h and it < cfg.max_iters]
        if not active:
            break
        n = max(1, min(min(chunk, cfg.max_iters - flags[b][2],
                           cfg.halt_window - flags[b][1]) for b in active))
        if tuple(active) != bound_for:     # the active set shrank
            bound_for = tuple(active)
            bind = stack_binds([binds[b] for b in active])
        step_keys = chunk_keys(keys, active, n, dev)
        every = len(active) == len(items)
        idx = None if every else torch.tensor(active, device=dev)
        sub = state if every else SpinnerState(*(
            x if f == "key" else x.index_select(0, idx)
            for f, x in zip(SpinnerState._fields, state)))
        for s in range(n):
            sub = _batched_step(cfg, sub, step_keys[s], bind)
        if every:
            state = sub
        else:
            state = SpinnerState(*(
                x if f == "key" else x.index_copy(0, idx, y)
                for f, x, y in zip(SpinnerState._fields, state, sub)))
    state = state._replace(key=tuple(keys))
    return [index_state(state, i) for i in range(len(items))]


# ---------------------------------------------------------------------------
# The sharded runner: SPMD over a torch.distributed mesh
# ---------------------------------------------------------------------------
# Every process runs the same host code on its own shard: the threefry key
# and every aggregate are replicated (each rank holds the same values), the
# labels are the rank's (v_local,) shard and the edges its ``RankShard``.
# The runner takes and returns the whole padded label vector (the same on
# every rank): it slices the rank's shard in and all-gathers the result out.

class ShardBind(NamedTuple):
    """Per-rank arguments of one sharded run."""

    deg_w: torch.Tensor        # (v_local,) f32 weighted degrees (0 on pads)
    capacity: torch.Tensor     # f32 scalar C (Eq. 5) of the REAL graph
    num_real: int              # global ids < num_real are real
    num_real_local: int        # rows of this shard that are real
    valid: torch.Tensor        # (v_local,) bool
    offset: int                # global id of the shard's row 0
    score: tuple               # the score backend's arrays of the shard
    plan_args: tuple           # the exchange plan's tensors for this rank
    frontier: tuple = ()       # ((src_local, dst), ...) expansion segments,
                               # dst in the plan's lookup index


def make_rank_sum(comm) -> Callable:
    """``reduce_(tensors) -> tensors``: each tensor summed over the ranks
    (the reference's ``psum``), in one all-gather of the packed float32
    parts (int32 parts bit-cast) and a sum in rank order.  The integer-
    valued parts are exact in any order; score(G) is a float32 sum, and a
    fixed order keeps it the same on every rank."""
    from .comm import gather_shards

    def reduce_(parts):
        flat = [p.reshape(-1) for p in parts]
        packed = torch.cat([f if f.dtype == torch.float32
                            else f.view(torch.float32) for f in flat])
        rows = gather_shards(packed[None], comm)
        out, pos = [], 0
        for part, f in zip(parts, flat):
            cols = rows[:, pos:pos + f.numel()]
            pos += f.numel()
            if f.dtype != torch.float32:
                cols = cols.contiguous().view(f.dtype)
            acc = cols[0]
            for r in range(1, comm.ndev):
                acc = acc + cols[r]
            out.append(acc.reshape(part.shape))
        return out

    return reduce_


def _sharded_draws(cfg, comm, v_local: int, noise_mode: str) -> Callable:
    """``draws(k_it, bind, dev) -> (noise, u)`` for this rank's rows:
    ``"replicated"`` takes the shard's rows of the whole padded draw
    (counters offset by the shard's first row), ``"folded"`` folds the rank
    into the iteration key and draws the shard alone."""
    k, tie = cfg.k, cfg.tie_noise

    def draws(k_it, bind: ShardBind, dev):
        if noise_mode == "folded":
            k_noise, k_mig = rng.split(rng.fold_in(k_it, comm.rank))
            return (rng.uniform(k_noise, (v_local, k), 0.0, tie, device=dev),
                    rng.uniform(k_mig, (v_local,), device=dev))
        k_noise, k_mig = rng.split(k_it)
        return (rng.uniform(k_noise, (v_local, k), 0.0, tie, device=dev,
                            offset=bind.offset * k),
                rng.uniform(k_mig, (v_local,), device=dev,
                            offset=bind.offset))

    return draws


def make_sharded_step_fn(cfg, comm, v_local: int, plan, scores,
                         noise_mode: str, overlap: bool = False,
                         fused: bool = False) -> Callable:
    """``step(state, aux, bind) -> (state, aux)``: one iteration on this
    rank's shard.

    ``state.labels`` is the rank's ``(v_local,)`` label shard; ``aux`` the
    exchange plan's carried state.  Without overlap the step is exchange
    -> score; with it, ``scores`` is the backend's ``(interior_fn,
    frontier_fn)`` pair over the ``[interior | frontier]`` segments and the
    step is ``start_exchange -> interior_fn -> finish_exchange ->
    frontier_fn``, the interior scored while the collective is in flight.
    Fused (``fused=True``): ``scores`` returns the iteration's outputs
    (under overlap, its frontier half seeds K1 with the interior partial).

    Draws: ``"replicated"`` takes the shard's rows of the whole padded
    draw (counters offset by the shard's first row), so at one device the
    streams are the single-device engine's; ``"folded"`` folds the rank
    into the iteration key and draws the shard alone.
    """
    eps = float(np.float32(cfg.eps))
    update = None if fused else make_vertex_update(cfg)
    reduce_ = make_rank_sum(comm)
    draws = _sharded_draws(cfg, comm, v_local, noise_mode)

    def step(state: SpinnerState, aux, bind: ShardBind):
        key, k_it = rng.split(state.key)
        labels = state.labels
        if overlap:
            interior_fn, frontier_fn = scores
            pending = plan.start_exchange(labels, aux, comm, *bind.plan_args)
            partial = interior_fn(labels, bind)
            lookup, aux, xbytes = plan.finish_exchange(pending)
        else:
            lookup, aux, xbytes = plan.exchange(labels, aux, comm,
                                                *bind.plan_args)
        noise, u = draws(k_it, bind, labels.device)
        if fused:
            fn = frontier_fn if overlap else scores
            head = (partial, lookup) if overlap else (lookup,)
            out = fn(*head, labels, state.loads, noise, u, bind, reduce_)
        else:
            scores_v = (frontier_fn(partial, lookup, labels, bind) if overlap
                        else scores(lookup, labels, bind))  # (v_local, k)
            out = update(scores_v, labels, bind.deg_w, state.loads, noise, u,
                         bind.valid, bind.capacity, reduce_)
        return _advance(state, key, *out, eps, cfg.halt_window,
                        cfg.max_iters, xbytes), aux

    return step


def make_sharded_frontier_step_fn(cfg, comm, v_local: int, plan, scores,
                                  noise_mode: str,
                                  fused: bool = False) -> Callable:
    """``step(state, aux, active, prev_lookup, bind) -> (state, aux, active,
    lookup, scored)``: one frontier iteration on this rank's shard.

    The exchange, draws and update are ``make_sharded_step_fn``'s without
    overlap, with the frontier additions of the reference: after the
    exchange, a local vertex with an edge whose looked-up dst label differs
    from the previous iteration's lookup becomes active (over every
    ``bind.frontier`` segment, in the plan's lookup index: global ids for
    allgather and delta, ``[local | halo]`` slots for the halo plans);
    ``valid`` is ``real & active``; the drain (``halted``) is a rank-summed
    count of vertices that want to move, equal to 0; the next active set is
    the pre-throttle ``want`` mask.  ``scored`` is the f32 rank-summed
    count of ``valid``, the same on every rank.  Fused (``fused=True``):
    ``scores`` is the backend's frontier form, which also returns
    ``want``.
    """
    eps = float(np.float32(cfg.eps))
    propose, finish = make_update_parts(
        cfg.k, degree_weighted=cfg.migration_weighting == "edges",
        current_bonus=cfg.current_bonus)
    reduce_ = make_rank_sum(comm)
    draws = _sharded_draws(cfg, comm, v_local, noise_mode)

    def step(state: SpinnerState, aux, active: torch.Tensor,
             prev_lookup: torch.Tensor, bind: ShardBind):
        key, k_it = rng.split(state.key)
        labels, loads = state.labels, state.loads
        lookup, aux, xbytes = plan.exchange(labels, aux, comm,
                                            *bind.plan_args)
        active = active | frontier_touched(lookup != prev_lookup,
                                           bind.frontier, rows=v_local)
        noise, u = draws(k_it, bind, labels.device)
        fbind = bind._replace(valid=bind.valid & active)
        valid = fbind.valid
        if fused:
            new_labels, new_loads, score_g, n_mig, mig_mass, want = scores(
                lookup, labels, loads, noise, u, fbind, reduce_)
        else:
            parts = propose(scores(lookup, labels, bind), labels,
                            bind.deg_w, loads, noise, valid, bind.capacity)
            want = (parts[0] != labels) & valid
            new_labels, new_loads, score_g, n_mig, mig_mass = finish(
                *parts, labels, bind.deg_w, loads, u, valid, bind.capacity,
                reduce_)
        scored, n_want = reduce_([valid.to(torch.float32).sum(),
                                  want.sum().to(torch.int32)])
        best, stall, _ = _halting_update(
            state.best_score, state.stall, score_g, eps, cfg.halt_window)
        new_state = SpinnerState(
            labels=new_labels, loads=new_loads, key=key, best_score=best,
            stall=stall, iteration=state.iteration + 1, halted=n_want == 0,
            total_messages=state.total_messages + mig_mass, score=score_g,
            migrations=n_mig, message_mass=mig_mass,
            exchanged_bytes=state.exchanged_bytes + xbytes)
        return new_state, aux, want, lookup, scored

    return step


def _default_partition_mesh(device=None):
    """1-D mesh over the whole process group (a one-rank group on an
    in-process store when there is none), cached per device type."""
    from ..launch.mesh import make_partition_mesh
    dev_type = resolve_device(device).type
    mesh = _DEFAULT_MESH.get(dev_type)
    if mesh is None:
        mesh = _DEFAULT_MESH[dev_type] = make_partition_mesh(device=device)
    return mesh


_DEFAULT_MESH: dict = {}


def _sharded_closures(backend, cfg, v_local: int, overlap: bool,
                      fused: bool, frontier: bool = False):
    """The backend's sharded closure (or split pair) and the function that
    reads its arrays off a ``RankShard``."""
    k = cfg.k
    kw = dict(degree_weighted=cfg.migration_weighting == "edges",
              current_bonus=float(cfg.current_bonus))
    if fused and frontier:
        return (backend.make_sharded_fused_update(k, v_local, frontier=True,
                                                  **kw),
                backend.sharded_fused_graph_args)
    if fused and overlap:
        return (backend.make_sharded_fused_update_split(k, v_local, **kw),
                backend.sharded_fused_graph_args_split)
    if fused:
        return (backend.make_sharded_fused_update(k, v_local, **kw),
                backend.sharded_fused_graph_args)
    if overlap:
        return (backend.make_sharded_scores_split(k, v_local),
                backend.sharded_graph_args_split)
    return (backend.make_sharded_scores(k, v_local),
            backend.sharded_graph_args)


def _sharded_parts(graph: Graph, cfg, opts: EngineOptions, mesh,
                   axis: str = "data", single_step: bool = False,
                   frontier: bool = False):
    """Everything a sharded run on this rank needs: ``(layout, plan, step,
    bind, comm)``.

    Resolves the exchange plan and the schedule, builds (or fetches from
    the padded graph's cache) the rank's segments in the plan's dst index
    and the backend's arrays.  The halo plans read the numpy
    ``ShardedGraph``; allgather and delta read only its sizes.
    ``single_step=True`` (the host-loop step) pins the aux-free allgather
    plan and no overlap, as the reference's does.  ``frontier=True``
    builds ``make_sharded_frontier_step_fn``'s step and the bind's
    expansion segment (the whole shard); it pins no overlap (the expansion
    needs the whole lookup before scoring) and the torch backend, and
    raises ``ValueError`` for any other, as the reference does for all but
    its XLA backend.
    """
    from ..launch.mesh import mesh_device
    from . import comm as comm_mod
    from .distributed import rank_shard, shard_geometry, shard_layout
    if single_step:
        opts = dataclasses.replace(opts, label_exchange="allgather",
                                   overlap="off")
    if frontier:
        opts = dataclasses.replace(opts, overlap="off")
        name = getattr(opts.backend(), "name", opts.backend())
        if name != "torch":
            raise ValueError(
                "frontier mode on the sharded engine requires the 'torch' "
                "score backend (its (src_local, dst) edge lists double as "
                "the frontier expansion index, as the reference's XLA "
                f"backend's do); got {name!r}")
    comm = comm_mod.mesh_comm(mesh, axis)
    ndev = comm.ndev
    device = mesh_device(mesh)
    want = opts.resolved_device()
    if want.type != device.type:
        raise ValueError(f"the mesh is on {device.type}, but the options ask "
                         f"for {want}")
    padded, num_real = padded_view(graph, opts)
    pad = opts.pad == "bucket"
    name = opts.resolved_label_exchange(ndev)
    overlap = opts.resolved_overlap(ndev) == "on"
    fused = opts.resolved_fused_update() == "on"
    noise_mode = opts.resolved_sharded_noise()
    halo = name in ("halo", "halo_delta")
    sg = (shard_layout(padded, ndev, pad=pad) if halo
          else shard_geometry(padded, ndev))
    plan = comm_mod.make_exchange_plan(name, sg, delta_cap=opts.delta_cap,
                                       pad=pad)
    if halo:
        shard = rank_shard(padded, ndev, comm.rank, device,
                           frontier_dst=plan.frontier_dst[comm.rank],
                           layout=("halo", pad, plan.halo_size))
    else:
        shard = rank_shard(padded, ndev, comm.rank, device)
    vl = shard.v_local
    backend = opts.backend()
    scores, args_of = _sharded_closures(backend, cfg, vl, overlap, fused,
                                        frontier)
    bind = ShardBind(
        deg_w=shard.deg_w,
        capacity=torch.tensor(cfg.capacity(graph), dtype=torch.float32,
                              device=device),
        num_real=num_real,
        num_real_local=min(max(num_real - shard.offset, 0), vl),
        valid=shard.offset + torch.arange(vl, device=device) < num_real,
        offset=shard.offset, score=tuple(args_of(shard)),
        plan_args=tuple(plan.device_args(comm.rank, device)),
        frontier=(shard.whole[1:3],) if frontier else ())
    if frontier:
        step = make_sharded_frontier_step_fn(cfg, comm, vl, plan, scores,
                                             noise_mode, fused=fused)
    else:
        step = make_sharded_step_fn(cfg, comm, vl, plan, scores, noise_mode,
                                    overlap=overlap, fused=fused)
    return sg, plan, step, bind, comm


def run_sharded_bound(cfg, opts: EngineOptions, plan, step, bind: ShardBind,
                      comm, state: SpinnerState,
                      single_step: bool = False) -> SpinnerState:
    """Run a state over the WHOLE padded label vector (the same on every
    rank) to the stable state on a given rank bind (one iteration with
    ``single_step``); the result's labels are all-gathered again.  The
    session's fast path hands it the bind over base + delta segments."""
    from .comm import gather_shards
    vl, off = bind.deg_w.shape[0], bind.offset
    local = state._replace(labels=state.labels[off:off + vl].contiguous())
    aux = [plan.init_aux(local.labels, comm, *bind.plan_args)]

    def advance(s: SpinnerState) -> SpinnerState:
        s, aux[0] = step(s, aux[0], bind)
        return s

    if single_step:
        out = advance(local)
    else:
        out = _chunk_loop(cfg, local, advance,
                          opts.chunk_size or DEFAULT_CHUNK)[0]
    return out._replace(labels=gather_shards(out.labels, comm))


def sharded_frontier_loop(cfg, plan, step, bind: ShardBind, comm,
                          state: SpinnerState, active: torch.Tensor
                          ) -> Tuple[SpinnerState, List[float]]:
    """Run a state over the WHOLE padded label vector in frontier mode
    until it drains (or reaches ``max_iters``); ``active`` is the padded
    mask, the same on every rank.  Returns ``(state, scored_per_iteration)``
    with the labels all-gathered again.

    The loop starts with ``plan.prime`` (the lookup of the initial labels,
    whose bytes count into ``exchanged_bytes``); then, as ``frontier_loop``
    does, the host reads the replicated drain flag and the scored count
    once per iteration, so every rank stops at the same iteration and
    nothing is launched after the drain.
    """
    from .comm import gather_shards
    vl, off = bind.deg_w.shape[0], bind.offset
    state = state._replace(labels=state.labels[off:off + vl].contiguous())
    lookup, aux, b0 = plan.prime(state.labels, comm, *bind.plan_args)
    state = state._replace(exchanged_bytes=state.exchanged_bytes + b0)
    carry = [aux, active[off:off + vl], lookup]

    def advance(s: SpinnerState):
        s, aux, act, lookup, count = step(s, *carry, bind)
        carry[:] = [aux, act, lookup]
        return s, count

    state, scored = _drain_loop(cfg, state, advance)
    return state._replace(labels=gather_shards(state.labels, comm)), scored


def make_sharded_runner(graph: Graph, cfg, mesh, axis: str = "data",
                        opts: Optional[EngineOptions] = None,
                        single_step: bool = False) -> Callable:
    """``runner(state) -> state`` on this rank: run to the stable state
    (with ``single_step``, one iteration), syncing with the host once per
    chunk.

    ``state.labels`` is the padded ``(ndev * v_per_dev,)`` vector of the
    sharded layout, the same on every rank, on the mesh's device; the
    result's labels are that vector again (all-gathered), so every rank
    returns the same state.  No kernel is launched after the halt, and
    every rank cuts its chunks at the same iterations: the halting state
    is replicated by construction.
    """
    opts = opts if opts is not None else EngineOptions()
    sg, plan, step, bind, comm = _sharded_parts(graph, cfg, opts, mesh, axis,
                                                single_step)

    def runner(state: SpinnerState) -> SpinnerState:
        if state.labels.shape[0] != sg.num_vertices:
            raise ValueError(f"state.labels has {state.labels.shape[0]} "
                             f"entries, the sharded layout {sg.num_vertices}")
        return run_sharded_bound(cfg, opts, plan, step, bind, comm, state,
                                 single_step)

    runner.v_pad = sg.num_vertices
    return runner


def sharded_v_pad(graph: Graph, opts: EngineOptions, mesh,
                  axis: str = "data") -> int:
    """Padded vertex count of the sharded layout (bucket + mesh rounding)."""
    from ..launch.mesh import mesh_size
    padded, _ = padded_view(graph, opts)
    ndev = mesh_size(mesh, axis)
    return -(-padded.num_vertices // ndev) * ndev


def run_sharded(graph: Graph, cfg, labels, loads, key: rng.Key,
                mesh=None, axis: str = "data",
                opts: Optional[EngineOptions] = None) -> SpinnerState:
    """Run to the stable state over ``mesh`` (``None``: the default mesh
    over the process group).  The returned state carries the PADDED labels
    of the sharded layout; callers slice ``[:graph.num_vertices]``."""
    from ..launch.mesh import mesh_device
    opts = opts if opts is not None else EngineOptions()
    if mesh is None:
        mesh = _default_partition_mesh(opts.device)
    runner = make_sharded_runner(graph, cfg, mesh, axis, opts)
    dev = mesh_device(mesh)
    labels = torch.as_tensor(labels, dtype=torch.int32).to(dev)
    state = init_state(pad_labels(labels, runner.v_pad),
                       torch.as_tensor(loads).to(dev), key)
    return runner(state)


def run_sharded_frontier(graph: Graph, cfg, labels, loads, key: rng.Key,
                         active, mesh=None, axis: str = "data",
                         opts: Optional[EngineOptions] = None
                         ) -> Tuple[SpinnerState, List[float]]:
    """Sharded frontier-mode run to drain over ``mesh`` (``None``: the
    default mesh): ``(state, scored_per_iteration)``.  ``active`` is a bool
    mask over the real vertex set; the returned state carries the PADDED
    labels of the sharded layout, the same on every rank.  Pins no
    overlap; on another score backend than ``"torch"`` it raises
    ``ValueError``."""
    from ..launch.mesh import mesh_device
    opts = opts if opts is not None else EngineOptions()
    if mesh is None:
        mesh = _default_partition_mesh(opts.device)
    sg, plan, step, bind, comm = _sharded_parts(graph, cfg, opts, mesh, axis,
                                                frontier=True)
    dev = mesh_device(mesh)
    labels = torch.as_tensor(labels, dtype=torch.int32).to(dev)
    state = init_state(pad_labels(labels, sg.num_vertices),
                       torch.as_tensor(loads).to(dev), key)
    return sharded_frontier_loop(cfg, plan, step, bind, comm, state,
                                 _pad_active(active, sg.num_vertices, dev))
