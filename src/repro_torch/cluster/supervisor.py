"""Partition-aware supervision: heartbeats, fault injection, restart policy.

The reference's ``repro.cluster.supervisor``, one supervisor per process
topology:

* :class:`PartitionSupervisor` drives a stream of ``(kind, kwargs)`` work
  items -- ``partition`` / ``adapt`` / ``update`` / ``resize`` -- through
  a ``PartitionSession``, snapshotting through ``repro_torch.cluster
  .snapshot`` every N completed items.  Injectable fault hooks simulate a
  worker kill (:func:`kill_worker_at`), a torn snapshot
  (:func:`corrupt_newest_snapshot_at`) and a slow worker
  (:func:`slow_worker_at`); the restart policy re-bootstraps the session
  on the surviving device count (``WorkerLost.surviving_ndev``) and
  resumes from the newest COMPLETE snapshot, skipping corrupt ones.  The
  base graph plus the work stream are the durable inputs and every session
  run is deterministic in (graph, cfg, previous labels), so a
  same-capacity restart replays to a bit-identical final state; a shrunk
  restart replays the elastic ``resize`` and reconverges.

* :class:`ProcessClusterSupervisor` owns real OS processes: per
  generation it hosts the store (``bootstrap.serve_store``, a fresh port
  the OS picks), spawns the workers (``bootstrap.spawn_local_worker``),
  watches exit codes and per-process heartbeat FILES
  (``<workdir>/hb/g<gen>_p<pid>``: a dead worker answers nothing, but its
  stale mtime still accuses it), and on a death or a stale heartbeat
  kills the generation and respawns on the surviving process count.
  Workers resume from the newest snapshot in ``<workdir>/snaps``.

Both report ``stats()``: restarts, snapshots written / restored /
corrupt-skipped, recovery times, heartbeat ages and the straggler
watchdog's ``flagged_steps``.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Dict, List, Optional, Sequence

# NOTE: import names, not the submodule -- the package re-exports a
# function called ``bootstrap`` that shadows the module attribute
from . import snapshot as _snapshot
from .bootstrap import serve_store, spawn_local_worker


class WorkerLost(RuntimeError):
    """A (simulated or real) worker death; carries surviving capacity."""

    def __init__(self, message: str,
                 surviving_ndev: Optional[int] = None):
        super().__init__(message)
        self.surviving_ndev = surviving_ndev


# ---------------------------------------------------------------------------
# Injectable fault hooks (step, supervisor, session) -> None
# ---------------------------------------------------------------------------

def kill_worker_at(step: int, surviving_ndev: Optional[int] = None,
                   worker: int = 0) -> Callable:
    """Raise :class:`WorkerLost` once, just before work item ``step``."""
    state = {"fired": False}

    def hook(i, sup, session):
        if i == step and not state["fired"]:
            state["fired"] = True
            raise WorkerLost(f"simulated kill of worker {worker} at "
                             f"item {i}", surviving_ndev=surviving_ndev)

    return hook


def corrupt_newest_snapshot_at(step: int) -> Callable:
    """Corrupt the newest snapshot once, before item ``step`` runs --
    deletes its manifest, exactly what a torn write looks like.  The
    restart must then fall back to the previous complete snapshot."""
    state = {"fired": False}

    def hook(i, sup, session):
        if i != step or state["fired"]:
            return
        state["fired"] = True
        steps = _snapshot.snapshot_steps(sup.cfg.snapshot_dir)
        if not steps:
            return
        path = os.path.join(sup.cfg.snapshot_dir,
                            f"step_{steps[-1]:08d}", _snapshot.MANIFEST)
        if os.path.exists(path):
            os.remove(path)
            sup.snapshots_corrupted += 1

    return hook


def slow_worker_at(step: int, seconds: float = 0.25) -> Callable:
    """Sleep inside one work item -- the straggler watchdog's bait."""
    state = {"fired": False}

    def hook(i, sup, session):
        if i == step and not state["fired"]:
            state["fired"] = True
            time.sleep(seconds)

    return hook


# ---------------------------------------------------------------------------
# In-process supervisor over a PartitionSession
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClusterSupervisorConfig:
    snapshot_dir: str
    snapshot_every: int = 1        # snapshot per N completed work items
    keep: int = 3
    straggler_factor: float = 3.0  # flag items slower than Nx median
    straggler_warmup: int = 3      # ... once this many items timed
    heartbeat_deadline: float = 30.0
    max_restarts: int = 3
    scale_k: bool = True           # rescale k with capacity on restore


class PartitionSupervisor:
    """Checkpointed, fault-tolerant execution of partition work items.

    ``session_factory(ndev)`` returns ``(graph, cfg, options)`` for a
    session bootstrapped on ``ndev`` devices (None = caller default) --
    the factory IS the re-bootstrap: after a failure it is invoked
    again with the surviving count, and the newest complete snapshot is
    restored onto whatever it builds (``snapshot.restore_session``
    replays the elastic ``resize`` when capacity changed).

    Work items are ``(kind, kwargs)``: ``("partition", {})``,
    ``("adapt", {...})``, ``("update", {...})``, ``("resize",
    {"k": n})``.  The stream plus the factory's base graph are the
    durable inputs; restart re-applies the completed prefix's graph
    mutations (``update`` / ``adapt(edge_updates=...)`` deltas,
    verified against the snapshot's ``delta_watermark``) to the
    rebuilt base graph, then resumes at the snapshot's item index and
    replays the tail, bit-identically on unchanged capacity.
    """

    def __init__(self, cfg: ClusterSupervisorConfig,
                 session_factory: Callable):
        self.cfg = cfg
        self.factory = session_factory
        self.restarts = 0
        self.snapshots_written = 0
        self.snapshots_restored = 0
        self.snapshots_corrupted = 0   # by injected faults
        self.corrupt_skipped = 0       # skipped during restore
        self.recover_seconds: List[float] = []
        self.step_times: List[float] = []
        self.flagged_steps: List[tuple] = []
        self._hb: Dict[int, float] = {}
        self.ndev: Optional[int] = None
        self.k: Optional[int] = None
        self.resized_on_restore = False

    # -- heartbeats --------------------------------------------------------

    def heartbeat(self, worker: int = 0) -> None:
        self._hb[worker] = time.monotonic()

    def heartbeat_ages(self) -> Dict[int, float]:
        now = time.monotonic()
        return {w: now - t for w, t in self._hb.items()}

    def stale_workers(self) -> List[int]:
        return [w for w, age in self.heartbeat_ages().items()
                if age > self.cfg.heartbeat_deadline]

    # -- the supervised run ------------------------------------------------

    @staticmethod
    def replay_graph_mutations(graph, work: Sequence[tuple], step: int):
        """Re-apply the graph mutations carried by ``work[:step]`` to the
        factory's base graph: ``update`` items, ``adapt`` items with
        ``edge_updates=`` (both delta batches -- ``add_edges`` weight
        semantics are order-independent, so per-item replay is exact)
        and ``adapt(new_graph=...)`` rebinds.  Returns ``(graph,
        n_delta_batches)``; the count must match the snapshot's
        ``delta_watermark`` for the rebuilt graph to be the logical
        graph the snapshot's labels reflect."""
        from ..core.graph import add_edges
        n_delta = 0
        for kind, kw in list(work)[:step]:
            if kind == "update":
                graph = add_edges(graph, kw["edge_src"], kw["edge_dst"],
                                  directed=kw.get("directed", True),
                                  num_vertices=kw.get("num_vertices"))
                n_delta += 1
            elif kind == "adapt":
                if kw.get("edge_updates") is not None:
                    e_src, e_dst = kw["edge_updates"]
                    graph = add_edges(graph, e_src, e_dst,
                                      num_vertices=kw.get("num_vertices"))
                    n_delta += 1
                elif kw.get("new_graph") is not None:
                    graph = kw["new_graph"]
        return graph, n_delta

    def _boot(self, ndev: Optional[int], work: Sequence[tuple] = ()):
        """(session, items_completed): a fresh session, fast-forwarded
        to the newest complete snapshot if one exists.  The factory
        returns the BASE graph, so before restoring, the graph
        mutations of the already-completed ``work[:step]`` prefix are
        replayed onto it (cross-checked against the snapshot's
        ``delta_watermark``) -- a snapshot's labels reflect those
        deltas, and resuming on a stale graph would silently diverge
        from the documented bit-identical replay."""
        graph, cfg, options = self.factory(ndev)
        if _snapshot.snapshot_steps(self.cfg.snapshot_dir):
            skipped: List[int] = []
            step, tree = _snapshot.newest_complete(
                self.cfg.snapshot_dir,
                on_corrupt=lambda s, e: skipped.append(s))
            graph, n_delta = self.replay_graph_mutations(graph, work, step)
            watermark = int(tree["delta_watermark"]) \
                if "delta_watermark" in tree else n_delta
            if n_delta != watermark:
                raise RuntimeError(
                    f"snapshot step {step} reflects {watermark} delta "
                    f"batches but work[:{step}] carries {n_delta}; the "
                    f"snapshot's logical graph cannot be rebuilt from "
                    f"the factory's base graph plus this work stream")
            info = _snapshot.restore_session(
                self.cfg.snapshot_dir, graph, options=options,
                ndev=ndev, scale_k=self.cfg.scale_k, step=step)
            self.corrupt_skipped += len(skipped)
            self.snapshots_restored += 1
            self.resized_on_restore |= info.resized
            self.k = info.k
            return info.session, info.step
        from ..core.session import PartitionSession
        session = PartitionSession(graph, cfg, options)
        self.k = cfg.k
        return session, 0

    def _dispatch(self, session, item):
        kind, kw = item
        if kind == "partition":
            return session.partition(record_history=False, **kw)
        if kind == "adapt":
            return session.adapt(record_history=False, **kw)
        if kind == "resize":
            res = session.resize(kw["k"], record_history=False)
            self.k = kw["k"]
            return res
        if kind == "update":
            session.update(**kw)
            return None
        raise ValueError(f"unknown work item kind {kind!r}")

    def run(self, work: Sequence[tuple], *,
            ndev: Optional[int] = None,
            faults: Sequence[Callable] = ()) -> tuple:
        """Drive ``work`` to completion with snapshots + restarts;
        returns ``(session, results)`` (one result per item, in order;
        replayed prefixes keep the result computed during THIS run's
        replay)."""
        self.ndev = ndev
        session, i = self._boot(ndev, work)
        results: list = [None] * len(work)
        attempts = 0
        while i < len(work):
            try:
                t0 = time.monotonic()   # before hooks: a slow-worker
                for hook in faults:     # fault counts as step walltime
                    hook(i, self, session)
                results[i] = self._dispatch(session, work[i])
                dt = time.monotonic() - t0
                self.step_times.append(dt)
                med = sorted(self.step_times)[len(self.step_times) // 2]
                if (len(self.step_times) > self.cfg.straggler_warmup
                        and dt > self.cfg.straggler_factor * med):
                    self.flagged_steps.append((i, dt, med))
                self.heartbeat(0)
                i += 1
                if (session.labels is not None
                        and i % self.cfg.snapshot_every == 0):
                    _snapshot.save_snapshot(
                        self.cfg.snapshot_dir, session, i,
                        ndev=self.ndev, keep=self.cfg.keep)
                    self.snapshots_written += 1
            except Exception as e:
                attempts += 1
                if attempts > self.cfg.max_restarts:
                    raise
                self.restarts += 1
                t0 = time.monotonic()
                surviving = getattr(e, "surviving_ndev", None)
                if surviving is not None:
                    self.ndev = surviving
                try:
                    session.close()
                except Exception:
                    pass
                session, i = self._boot(self.ndev, work)
                self.recover_seconds.append(time.monotonic() - t0)
        if session.labels is not None:
            _snapshot.save_snapshot(self.cfg.snapshot_dir, session,
                                    len(work), ndev=self.ndev,
                                    keep=self.cfg.keep)
            self.snapshots_written += 1
        return session, results

    def stats(self) -> dict:
        """Restart/snapshot counters, recovery times, heartbeat ages and
        the straggler watchdog report (same shape as
        ``TrainSupervisor.stats()``'s, reported side by side)."""
        times = sorted(self.step_times)
        return {
            "restarts": self.restarts,
            "snapshots_written": self.snapshots_written,
            "snapshots_restored": self.snapshots_restored,
            "snapshots_corrupted": self.snapshots_corrupted,
            "corrupt_skipped": self.corrupt_skipped,
            "recover_seconds": list(self.recover_seconds),
            "ndev": self.ndev,
            "k": self.k,
            "resized_on_restore": self.resized_on_restore,
            "heartbeat_ages": self.heartbeat_ages(),
            "stale_workers": self.stale_workers(),
            "straggler": {
                "steps": len(self.step_times),
                "median_step_time": (times[len(times) // 2]
                                     if times else None),
                "straggler_factor": self.cfg.straggler_factor,
                "flagged_steps": list(self.flagged_steps),
            },
        }


# ---------------------------------------------------------------------------
# Process-level supervisor (real subprocess workers)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProcessClusterConfig:
    workdir: str
    num_processes: int = 2
    heartbeat_deadline: float = 60.0
    poll_interval: float = 0.25
    max_restarts: int = 2
    # a torch import, a CUDA context and the shard loads before the first
    # beat of a superstep
    spawn_grace: float = 120.0


class ProcessClusterSupervisor:
    """Generation manager for real worker OS processes.

    Each generation: host a fresh store (port 0: the OS picks it), spawn
    ``world`` workers against it, then watch.  A worker that exits
    nonzero or whose heartbeat file goes stale is declared dead; the
    whole generation is killed (synchronous supersteps cannot outlive a
    peer) and the next one respawns with the survivors' count.  Workers
    resume from the newest snapshot in ``<workdir>/snaps``, written by
    process 0, so recovery needs no human intervention.  The store lives
    here, not in worker 0, so losing worker 0 loses no coordinator.
    """

    def __init__(self, cfg: ProcessClusterConfig, job: dict):
        self.cfg = cfg
        self.job = dict(job)
        self.restarts = 0
        self.generations: List[dict] = []
        self.recover_seconds: List[float] = []
        os.makedirs(cfg.workdir, exist_ok=True)
        os.makedirs(os.path.join(cfg.workdir, "hb"), exist_ok=True)

    def _write_job(self) -> None:
        import json
        with open(os.path.join(self.cfg.workdir, "job.json"), "w") as f:
            json.dump(self.job, f)

    def _hb_age(self, gen: int, pid: int, now: float) -> Optional[float]:
        """Seconds since the worker's last beat; ``now`` is wall-clock
        time, as the file's mtime is."""
        path = os.path.join(self.cfg.workdir, "hb", f"g{gen}_p{pid}")
        try:
            return now - os.path.getmtime(path)
        except OSError:
            return None                       # not born yet

    def _watch(self, gen: int, procs: list, started: float) -> List[int]:
        """Block until the generation finishes; returns the list of
        dead pids ([] = clean success)."""
        while True:
            time.sleep(self.cfg.poll_interval)
            now = time.monotonic()
            wall = time.time()
            rcs = [p.poll() for p in procs]
            dead = [i for i, rc in enumerate(rcs)
                    if rc is not None and rc != 0]
            if dead:
                return dead
            if all(rc == 0 for rc in rcs):
                return []
            if now - started > self.cfg.spawn_grace:
                stale = [i for i, rc in enumerate(rcs) if rc is None
                         and (self._hb_age(gen, i, wall) or 0)
                         > self.cfg.heartbeat_deadline]
                if stale:
                    return stale

    def _kill_all(self, procs: list) -> None:
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGKILL)
                except OSError:
                    pass
        for p in procs:
            try:
                p.wait(timeout=30)
            except Exception:
                pass

    def run(self) -> dict:
        """Run generations until the job completes; returns stats plus
        the job's result.json payload."""
        import json
        self._write_job()
        world = self.cfg.num_processes
        gen = 0
        while True:
            store = serve_store()
            port = store.port
            started = time.monotonic()
            procs = [spawn_local_worker(
                workdir=self.cfg.workdir, gen=gen, world=world, pid=p,
                port=port) for p in range(world)]
            try:
                dead = self._watch(gen, procs, started)
            finally:
                self._kill_all(procs)
                del store             # the generation's keys go with it
            self.generations.append({"gen": gen, "world": world,
                                     "port": port, "dead": dead,
                                     "seconds": time.monotonic() - started})
            if not dead:
                break
            if self.restarts >= self.cfg.max_restarts:
                raise WorkerLost(
                    f"generation {gen}: workers {dead} died and restart "
                    f"budget ({self.cfg.max_restarts}) is exhausted")
            t0 = time.monotonic()
            self.restarts += 1
            world = max(1, world - len(dead))
            gen += 1
            self.recover_seconds.append(time.monotonic() - t0)
        with open(os.path.join(self.cfg.workdir, "result.json")) as f:
            result = json.load(f)
        return {"result": result, "restarts": self.restarts,
                "generations": self.generations,
                "recover_seconds": self.recover_seconds}
