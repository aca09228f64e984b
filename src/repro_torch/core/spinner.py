"""Spinner: k-way balanced label propagation (Sections 3.1-3.3, 4.1).

One LPA iteration is two phases, as in the Pregel implementation:

  ComputeScores     scores''(v, l) = sum_{u in N(v)} w(u,v) delta(a(u), l)
                                     / deg_w(v) - pi(l)            (Eq. 8)
  ComputeMigrations probabilistic throttle p(l) = R(l)/M(l)        (Eq. 12)

Halting (Section 3.3): stop when score(G) has not improved by more than
eps (relative) for ``halt_window`` consecutive iterations.

``partition`` runs on the CUDA card unless the options ask for the CPU,
and picks a runner from ``repro_torch.core.engine``: "fused" (no
history, one host sync per chunk), "chunked" (history recorded on the
device), "host" (the per-iteration loop, with history through
``metrics``), or "auto" ("fused" when ``record_history is False`` and
there is no callback, else "chunked").  Every runner draws the
reference's random streams (``repro_torch.rng``), so for one seed and
one padded layout the labels, loads and iteration count equal the
reference package's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import rng
from . import engine as _engine
from . import metrics
from .engine import EngineOptions
from .graph import Graph

_ENGINES = ("auto", "fused", "chunked", "host")


@dataclasses.dataclass(frozen=True)
class SpinnerConfig:
    """The paper's algorithm parameters (Sections 3.1-3.5) -- nothing else."""

    k: int
    c: float = 1.05                    # capacity slack (Eq. 5)
    eps: float = 1e-3                  # halting threshold (Section 3.3)
    halt_window: int = 5               # w consecutive non-improving iters
    max_iters: int = 300
    seed: int = 0
    # "edges" weighs migration candidates by degree in M(l) (the units of
    # R(l)); "vertices" counts them, as Eq. 12's text does.
    migration_weighting: str = "edges"
    tie_noise: float = 1e-7            # random tie-break amplitude
    current_bonus: float = 1e-6        # prefer the current label on ties

    def capacity(self, graph: Graph) -> float:
        """C per Eq. (5), in weighted-degree units."""
        return self.c * graph.total_weight / self.k


@dataclasses.dataclass
class PartitionResult:
    labels: np.ndarray                  # (V,) int32 final assignment
    loads: np.ndarray                   # (k,) float32 B(l)
    iterations: int
    halted: bool                        # True if the eps/w criterion fired
    history: List[dict]                 # per-iteration phi/rho/score/...
    total_messages: float = 0.0         # sum of migrant degrees (network load)
    engine: str = "host"                # which runner produced this result


def init_labels(graph: Graph, cfg: SpinnerConfig, key: rng.Key,
                device) -> torch.Tensor:
    """Initializer step: uniform random labels (Section 4.1.1)."""
    return rng.randint(key, (graph.num_vertices,), 0, cfg.k, device=device)


def compute_loads(graph: Graph, labels: torch.Tensor, k: int) -> torch.Tensor:
    """B(l) per Eq. (6) on the labels' device (integer sums, exact)."""
    deg = torch.from_numpy(np.ascontiguousarray(graph.deg_w, np.float32))
    loads = torch.zeros(k, dtype=torch.float32, device=labels.device)
    return loads.index_add_(0, labels.long(), deg.to(labels.device))


def prepare_init(graph: Graph, cfg: SpinnerConfig,
                 init: Optional[np.ndarray] = None, *, device):
    """Shared prologue: initial (labels, loads, key) for every engine.

    ``init`` supplies labels for incremental/elastic restarts (Sections
    3.4-3.5); entries equal to -1 go to the least-loaded partitions,
    mirroring the paper's treatment of new vertices.
    """
    key = rng.PRNGKey(cfg.seed)
    key, k_init = rng.split(key)
    if init is None:
        labels = init_labels(graph, cfg, k_init, device)
    else:
        init = np.asarray(init, dtype=np.int32)
        if init.shape != (graph.num_vertices,):
            raise ValueError(f"init has shape {init.shape}, expected "
                             f"({graph.num_vertices},)")
        if (init < 0).any():
            # New vertices -> least loaded partition (Section 3.4).
            known = init >= 0
            loads_np = np.zeros(cfg.k, np.float64)
            np.add.at(loads_np, init[known], graph.deg_w[known])
            fill = np.argsort(loads_np, kind="stable")[
                np.arange(int((~known).sum())) % cfg.k]
            init = init.copy()
            init[~known] = fill.astype(np.int32)
        labels = torch.from_numpy(init).to(device)
    loads = compute_loads(graph, labels, cfg.k)
    return labels, loads, key


def _run_host(graph: Graph, cfg: SpinnerConfig, opts: EngineOptions,
              labels, loads, key: rng.Key, record_history: bool,
              callback) -> PartitionResult:
    """Per-iteration host loop -- the other runners' oracle.

    Same padded layout and step as the chunk loop; the halting compare
    runs in numpy float32, matching the device's ``_halting_update`` bit
    for bit.
    """
    step = _engine.make_host_step(graph, cfg, opts, labels.device)
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
        labels, loads, score_g, n_mig, mig_mass = step(labels, loads, k_it)
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
        # on iteration 1 best_score is -inf, tol is inf and best + tol is
        # NaN: the compare is False (the invalid-op warning is expected)
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


def partition(graph: Graph,
              cfg: SpinnerConfig,
              init: Optional[np.ndarray] = None,
              record_history: Optional[bool] = None,
              callback: Optional[Callable[[int, dict], None]] = None,
              engine: str = "auto",
              chunk_size: Optional[int] = None,
              options: Optional[EngineOptions] = None,
              device=None,
              ) -> PartitionResult:
    """Run Spinner to a stable state (Sections 3.3, 4.1).

    ``engine`` / ``chunk_size`` / ``device`` override the same fields of
    ``options``.  The run is on the CUDA card unless the device is
    ``"cpu"``; with no card it raises instead of falling back.
    ``record_history=None`` records where the runner can (host, chunked);
    asking the fused runner for history or a callback is an error.
    """
    opts = options if options is not None else EngineOptions()
    over = {}
    if engine != "auto":
        over["engine"] = engine
    if chunk_size is not None:
        over["chunk_size"] = chunk_size
    if device is not None:
        over["device"] = device
    if over:
        opts = dataclasses.replace(opts, **over)
    eng = opts.engine
    if eng == "sharded":
        raise NotImplementedError(
            "engine='sharded' is not ported to PyTorch yet (ROADMAP.md "
            "Slice D)")
    if eng not in _ENGINES:
        raise ValueError(f"unknown engine {eng!r}; "
                         f"available: {', '.join(_ENGINES)}")
    if eng == "auto":
        eng = ("fused" if record_history is False and callback is None
               else "chunked")
    dev = opts.resolved_device()

    labels, loads, key = prepare_init(graph, cfg, init, device=dev)
    if eng == "host":
        return _run_host(graph, cfg, opts, labels, loads, key,
                         record_history is not False, callback)
    if eng == "fused":
        if callback is not None:
            raise ValueError("engine='fused' cannot invoke a per-iteration "
                             "callback; use engine='chunked' (or 'auto')")
        if record_history is True:
            raise ValueError("engine='fused' cannot record per-iteration "
                             "history; use engine='chunked' (or 'auto')")
        state = _engine.run_fused(graph, cfg, labels, loads, key, opts)
        history = []
    else:   # chunked
        record = record_history is not False
        state, history = _engine.run_chunked(
            graph, cfg, labels, loads, key, opts,
            chunk_size=opts.chunk_size or _engine.DEFAULT_CHUNK,
            callback=callback, record=record)
        if not record:
            history = []     # a callback forces recording internally
    return PartitionResult(
        labels=state.labels.cpu().numpy(),
        loads=state.loads.cpu().numpy(),
        iterations=int(state.iteration),
        halted=bool(state.halted), history=history,
        total_messages=float(state.total_messages), engine=eng)
