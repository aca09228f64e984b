"""Spinner: k-way balanced label propagation (Sections 3.1-3.3, 4.1).

One LPA iteration is two phases, as in the Pregel implementation:

  ComputeScores     scores''(v, l) = sum_{u in N(v)} w(u,v) delta(a(u), l)
                                     / deg_w(v) - pi(l)            (Eq. 8)
  ComputeMigrations probabilistic throttle p(l) = R(l)/M(l)        (Eq. 12)

Halting (Section 3.3): stop when score(G) has not improved by more than
eps (relative) for ``halt_window`` consecutive iterations.

``partition`` runs on the CUDA card unless the options ask for the CPU.
It opens a throwaway ``PartitionSession`` (``repro_torch.core.session``),
as the reference does, so one code path serves both; the session picks a
runner from ``repro_torch.core.engine``: "fused" (no history, one host
sync per chunk), "chunked" (history recorded on the device), "host" (the
per-iteration loop, with history through ``metrics``), "sharded" (the
fused loop SPMD over a ``torch.distributed`` mesh, one process per
device; a 1-device mesh reproduces "fused" exactly), or "auto" ("sharded"
with a mesh, else "fused" when ``record_history is False`` and there is no
callback, else "chunked").  Every runner draws the reference's random streams
(``repro_torch.rng``), so for one seed and one padded layout the labels,
loads and iteration count equal the reference package's.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import rng
from . import engine as _engine
from .engine import EngineOptions
from .graph import Graph


class SpinnerDeprecationWarning(DeprecationWarning):
    """Deprecated use of engine/runtime knobs on ``SpinnerConfig``.

    A subclass of its own so that the in-repo deprecation surface can be
    turned into errors (``-W error::repro_torch.core.spinner.
    SpinnerDeprecationWarning``) without touching third-party warnings.
    """


# Deprecated engine-era fields and their "unset" sentinels.
_LEGACY_FIELDS = {"use_kernel": False, "score_backend": None,
                  "label_exchange": None, "delta_cap": None,
                  "sharded_noise": None}
# the reference's backend names, as this package spells them
_LEGACY_BACKENDS = {"pallas": "cuda", "xla": "torch"}


@dataclasses.dataclass(frozen=True)
class SpinnerConfig:
    """The paper's algorithm parameters (Sections 3.1-3.5) -- nothing else.

    Engine/runtime knobs live in ``EngineOptions``.  The trailing fields
    are the reference's deprecation shim for the pre-session API: setting
    any of them warns ``SpinnerDeprecationWarning`` and
    ``resolve_options`` folds them into the options (``use_kernel=True``
    and ``score_backend="pallas"`` become the ``"cuda"`` backend,
    ``"xla"`` the ``"torch"`` one).
    """

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
    # ---- deprecated shim (moved to EngineOptions) ----------------------
    use_kernel: bool = False           # -> EngineOptions(score_backend=...)
    score_backend: Optional[str] = None
    label_exchange: Optional[str] = None
    delta_cap: Optional[int] = None
    sharded_noise: Optional[str] = None

    def __post_init__(self):
        legacy = [f for f, unset in _LEGACY_FIELDS.items()
                  if getattr(self, f) != unset]
        if legacy:
            warnings.warn(
                f"SpinnerConfig({', '.join(legacy)}) is deprecated: "
                "engine/runtime knobs moved to "
                "repro_torch.core.engine.EngineOptions (pass options= to "
                "partition()/PartitionSession)",
                SpinnerDeprecationWarning, stacklevel=3)

    def capacity(self, graph: Graph) -> float:
        """C per Eq. (5), in weighted-degree units."""
        return self.c * graph.total_weight / self.k


def _scrub_legacy(cfg: SpinnerConfig) -> SpinnerConfig:
    """The config with the deprecated fields reset to their sentinels, so
    internal ``dataclasses.replace`` calls never warn again."""
    if any(getattr(cfg, f) != unset for f, unset in _LEGACY_FIELDS.items()):
        return dataclasses.replace(cfg, **_LEGACY_FIELDS)
    return cfg


def resolve_options(cfg: SpinnerConfig,
                    options: Optional[EngineOptions] = None, *,
                    engine: str = "auto",
                    chunk_size: Optional[int] = None,
                    mesh=None,
                    axis: str = "data",
                    device=None,
                    ) -> tuple:
    """Merge (options, per-call kwargs, deprecated config fields).

    Returns ``(scrubbed cfg, resolved EngineOptions)``.  Precedence:
    explicit per-call kwargs > an explicit ``options`` object > the
    deprecated ``SpinnerConfig`` fields, which only fill options still at
    their defaults.
    """
    opts = options if options is not None else EngineOptions()
    over = {}
    if engine != "auto":
        over["engine"] = engine
    if chunk_size is not None:
        over["chunk_size"] = chunk_size
    if mesh is not None:
        over["mesh"] = mesh
    if axis != "data":
        over["axis"] = axis
    if device is not None:
        over["device"] = device
    if opts.score_backend == EngineOptions.score_backend:
        if cfg.score_backend is not None:
            over["score_backend"] = _LEGACY_BACKENDS.get(
                cfg.score_backend, cfg.score_backend)
        elif cfg.use_kernel:
            over["score_backend"] = "cuda"
    if cfg.label_exchange is not None and opts.label_exchange == "auto":
        over["label_exchange"] = cfg.label_exchange
    if cfg.delta_cap is not None and opts.delta_cap is None:
        over["delta_cap"] = cfg.delta_cap
    if cfg.sharded_noise is not None and opts.sharded_noise == "replicated":
        over["sharded_noise"] = cfg.sharded_noise
    if over:
        opts = dataclasses.replace(opts, **over)
    return _scrub_legacy(cfg), opts


@dataclasses.dataclass
class PartitionResult:
    labels: np.ndarray                  # (V,) int32 final assignment
    loads: np.ndarray                   # (k,) float32 B(l)
    iterations: int
    halted: bool                        # True if the eps/w criterion fired
    history: List[dict]                 # per-iteration phi/rho/score/...
    total_messages: float = 0.0         # sum of migrant degrees (network load)
    engine: str = "host"                # which runner produced this result
    exchanged_bytes: float = 0.0        # label-exchange wire bytes (0.0 at
                                        # one device: nothing is exchanged)
    scored_vertices: float = -1.0       # vertices scored across the run
                                        # (frontier mode only; -1 = dense)
    scored_per_iter: tuple = ()         # frontier mode: scored-vertex count
                                        # per iteration


def init_labels(graph: Graph, cfg: SpinnerConfig, key: rng.Key,
                device) -> torch.Tensor:
    """Initializer step: uniform random labels (Section 4.1.1)."""
    return rng.randint(key, (graph.num_vertices,), 0, cfg.k, device=device)


def compute_loads(graph: Graph, labels: torch.Tensor, k: int) -> torch.Tensor:
    """B(l) per Eq. (6) on the labels' device (integer sums, exact)."""
    deg = torch.from_numpy(np.ascontiguousarray(graph.deg_w, np.float32))
    loads = torch.zeros(k, dtype=torch.float32, device=labels.device)
    return loads.index_add_(0, labels.long(), deg.to(labels.device))


def make_step(graph: Graph, cfg: SpinnerConfig, *,
              device=None) -> Callable:
    """One LPA iteration bound to ``graph`` at its exact shapes (no
    padding): ``step(labels, loads, key) -> (labels, loads, score_g,
    n_mig, mig_mass)``, ``key`` the iteration's key.  The reference's
    ``make_step(graph, cfg)``, kept for host-loop callers; it runs on the
    card unless ``device="cpu"``."""
    cfg, opts = resolve_options(cfg, device=device)
    opts = dataclasses.replace(opts, pad="none")
    return _engine.make_host_step(graph, cfg, opts, opts.resolved_device())


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


def partition(graph: Graph,
              cfg: SpinnerConfig,
              init: Optional[np.ndarray] = None,
              record_history: Optional[bool] = None,
              callback: Optional[Callable[[int, dict], None]] = None,
              engine: str = "auto",
              chunk_size: Optional[int] = None,
              mesh=None,
              axis: str = "data",
              options: Optional[EngineOptions] = None,
              device=None,
              ) -> PartitionResult:
    """Run Spinner to a stable state (Sections 3.3, 4.1).

    A thin wrapper that opens a throwaway ``PartitionSession`` with the
    resolved options and runs it once, so results equal the same call
    through a live session.  ``engine`` / ``chunk_size`` / ``device``
    override the same fields of ``options``, and so do ``mesh`` / ``axis``:
    ``engine="sharded"`` runs over ``mesh`` (``None``: the default mesh,
    ``repro_torch.launch.mesh.make_partition_mesh``), and every process of
    the mesh makes the same call.  The run is on the CUDA card
    unless the device is ``"cpu"``; with no card it raises instead of
    falling back.  ``record_history=None`` records where the runner can
    (host, chunked); asking the fused runner for history or a callback is
    an error.
    """
    cfg, opts = resolve_options(cfg, options, engine=engine,
                                chunk_size=chunk_size, mesh=mesh, axis=axis,
                                device=device)
    from .session import PartitionSession    # lazy: session imports us
    with PartitionSession(graph, cfg, opts) as session:
        return session.partition(init=init, record_history=record_history,
                                 callback=callback)
