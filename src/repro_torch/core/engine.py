"""Single-device Spinner LPA engine in PyTorch.

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
    ``spinner.py``.

PyTorch has no device-side while loop, so the chunk loop syncs with the
host once per chunk and sizes each chunk so the run cannot halt before
the chunk's last step: ``stall`` rises by at most one per iteration, so a
run with ``stall`` s cannot halt within ``halt_window - s - 1`` steps.
No kernel is launched after the halt, and iteration counts equal the
reference's.  Inside the chunk the halting state is a device mask: a step
on a halted state passes it through unchanged, as the reference's guarded
scan does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

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

_SHARDED_ONLY = {"mesh": None, "label_exchange": "auto", "delta_cap": None,
                 "sharded_noise": "replicated"}


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
    on for backends that advertise ``fused_auto``.  The sharded engine's
    options (``mesh``, ``label_exchange``, ``delta_cap``,
    ``sharded_noise``, ``overlap="on"``) are not ported yet and raise.
    """

    engine: str = "auto"             # auto | fused | chunked | host
    chunk_size: Optional[int] = None
    score_backend: Union[str, object] = "cuda"
    fused_update: str = "auto"       # auto | on | off
    pad: str = "bucket"              # bucket | none
    device: Optional[Union[str, torch.device]] = None
    mesh: object = None
    label_exchange: str = "auto"
    delta_cap: Optional[int] = None
    sharded_noise: str = "replicated"
    overlap: str = "auto"

    def __post_init__(self):
        if self.overlap not in ("auto", "on", "off"):
            raise ValueError(f"unknown overlap {self.overlap!r}; "
                             "available: auto, on, off")
        set_ = [f for f, unset in _SHARDED_ONLY.items()
                if getattr(self, f) != unset]
        if self.overlap == "on":
            set_.append("overlap")
        if set_:
            raise NotImplementedError(
                f"EngineOptions({', '.join(set_)}) belongs to the sharded "
                "engine, which the PyTorch port does not have yet (ROADMAP.md "
                "Slice D)")

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
    )


class GraphBind(NamedTuple):
    """Per-graph arguments of one run on the padded layout."""

    deg_w: torch.Tensor        # (V_pad,) f32 weighted degrees (0 on pads)
    capacity: torch.Tensor     # f32 scalar C (Eq. 5) of the REAL graph
    num_real: int              # vertices < num_real are real
    valid: torch.Tensor        # (V_pad,) bool, arange < num_real
    score: tuple               # score backend's device arrays
    hist: tuple = ()           # (src, dst, real_entry, ideal, real_e)


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
              hist: bool = False) -> Tuple[GraphBind, Graph]:
    """The bind of one run: the padded graph's arrays on ``device``."""
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
        score=score, hist=hist_args), padded


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
    """

    def propose(scores, labels, deg_w, loads, noise, valid, C):
        return propose_ref(scores, labels, deg_w, loads / C, noise, valid,
                           k, current_bonus, degree_weighted)

    def finish(best, tot_best, tot_cur, m_partial, labels, deg_w, loads,
               u, valid, C):
        want = (best != labels) & valid
        # ---- ComputeMigrations (Eq. 11-12) -----------------------------
        R = torch.clamp(C - loads, min=0.0)                       # Eq. 11
        p = torch.clamp(R / torch.clamp(m_partial, min=1e-9), 0.0, 1.0)
        migrate = want & (u < p[best.long()])                     # Eq. 12
        new_labels = torch.where(migrate, best, labels)
        mig_deg = torch.where(migrate, deg_w, 0.0)
        delta = torch.zeros(k, dtype=torch.float32, device=loads.device)
        delta.index_add_(0, best.long(), mig_deg)
        delta.index_add_(0, labels.long(), -mig_deg)
        new_loads = loads + delta
        # ---- halting aggregate: score(G) at the new assignment (Eq. 9) --
        sel = torch.where(valid, torch.where(migrate, tot_best, tot_cur),
                          0.0)
        score_g = sel.sum()
        n_mig = migrate.sum().to(torch.int32)
        mig_mass = mig_deg.sum()
        return new_labels, new_loads, score_g, n_mig, mig_mass

    return propose, finish


def make_vertex_update(cfg) -> Callable:
    """``update(scores, labels, deg_w, loads, noise, u, valid, C)``: the
    two halves composed, for the split (dense scores) path."""
    propose, finish = make_update_parts(
        cfg.k, degree_weighted=cfg.migration_weighting == "edges",
        current_bonus=cfg.current_bonus)

    def update(scores, labels, deg_w, loads, noise, u, valid, C):
        parts = propose(scores, labels, deg_w, loads, noise, valid, C)
        return finish(*parts, labels, deg_w, loads, u, valid, C)

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
        labels, loads, score_g, n_mig, mig_mass = iterate(
            state.labels, state.loads, k_it, bind)
        best, stall, halted = _halting_update(
            state.best_score, state.stall, score_g, eps, halt_window)
        active = ~state.halted & (state.iteration < max_iters)

        def keep(new, old):
            return torch.where(active, new, old)

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
            message_mass=keep(mig_mass, state.message_mass))

    return step


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


def _run_chunks(graph: Graph, cfg, state: SpinnerState, opts: EngineOptions,
                chunk_size: int, record: bool,
                callback: Optional[Callable] = None
                ) -> Tuple[SpinnerState, List[dict]]:
    """The chunk loop behind ``run_fused`` and ``run_chunked``.

    ``state`` covers the real vertices; it is padded in and sliced out.
    Each chunk is at most ``chunk_size`` steps, cut short so that the run
    can only halt at the chunk's last step (see the module docstring);
    the host reads the halting state once per chunk and, with ``record``,
    the chunk's history entries.
    """
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    dev = _state_device(state, opts)
    bind, padded = make_bind(graph, cfg, opts, dev, hist=record)
    step = make_step(cfg, opts)
    state = state._replace(labels=pad_labels(state.labels,
                                             padded.num_vertices))
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
            state = step(state, bind)
            if record:
                recs.append(_record(state, bind))
        if recs:
            cols = {f: torch.stack([r[f].to(torch.float64) for r in recs])
                    .tolist() for f in _RECORD_TYPES}
            for i in range(len(recs)):
                entry = {f: cast(cols[f][i])
                         for f, cast in _RECORD_TYPES.items()}
                history.append(entry)
                if callback is not None:
                    callback(entry["iteration"], entry)
    return state._replace(labels=state.labels[:graph.num_vertices]), history


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
