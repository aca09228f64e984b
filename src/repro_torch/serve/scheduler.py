"""PartitionScheduler: many PartitionSessions behind one request queue.

Spinner frames partitioning as a continuously running cloud service
(§ dynamicity); this module is that serving tier.  One scheduler holds
many independent tenants (graph + ``PartitionSession``) and drains a
stream of ``partition`` / ``edge_updates`` / ``adapt`` / ``resize``
requests through three layers, as the reference's ``repro.serve.scheduler``:

1. **Delta coalescing** (``core.delta.coalesce_updates``): each dispatch
   round pops a tenant's leading run of queued edge-update requests (plus
   at most one trailing plain ``adapt``) as ONE window; the coalesced
   delta folds through a single merge and one reconvergence, and every
   ticket in the window resolves to the result a one-by-one replay gives.

2. **Same-bucket batched execution** (``engine.run_batched``): windows
   from tenants whose work items share an ``engine.batch_signature``
   (static config, backend, fused flag, padded ``(V, E)``) run as ONE
   batched run, each tenant's result bit-identical to its own serial
   adapt.  Ineligible windows (``partition``, ``resize``, rebinds,
   frontier adapts; sharded, chunked and host sessions, and the CUDA
   backend, whose K1 runs per tenant) dispatch serially through the
   session's own entry points.

3. **Prefetch policies**, run between the batched runs and the commits:
   :class:`StagePrefetch` double-buffers the next queued snapshot rebind
   (``stage()`` as a policy) and :class:`KSweepPrecompile` scans for
   queued ``resize`` targets.

Dispatch order is priority-weighted staleness (age of the tenant's
oldest queued request x tenant priority), with an optional hard
``preempt_staleness`` SLO that jumps an aging tenant to the front.

The port departs from the reference in three places:

* **No compile accounting.**  PyTorch runs eagerly and the kernels build
  once per source hash (``kernels/_build.py``), so nothing compiles per
  graph or batch size.  The scheduler reports ``uploads`` instead: the
  O(E) padded-CSR uploads of every session, live or retired
  (``PartitionSession.uploads``); ``mark()`` snapshots them and
  ``stats()["uploads_since_mark"]`` is zero for a warm fleet.
* **``KSweepPrecompile``** keeps its name, its one-(tenant, k)-per-round
  scan and its ``warmed`` count, but ``compiled`` stays 0: there is
  nothing to compile per k.
* **``default_batch_min``** asks ``torch.cuda.is_available()`` where the
  reference asks ``jax.devices()``.

Under ``deployment=`` (``repro_torch.cluster.ClusterDeployment``) every
tenant is admitted through the deployment (pinned to its mesh),
snapshotted after committed dispatches on its cadence, and a dispatch that
raises is recovered from the tenant's newest snapshot and retried once;
without one, a failed dispatch fails its window.

A scheduler on a machine without a card raises on ``add_tenant`` unless
the tenant's options ask for ``device="cpu"`` (the session's own rule).

::

    from repro_torch.serve import PartitionScheduler

    sched = PartitionScheduler(max_batch=8)
    opts = EngineOptions(score_backend="torch")       # batchable tenants
    sched.add_tenant("social", g1, SpinnerConfig(k=16), opts, partition=True)
    sched.add_tenant("web", g2, SpinnerConfig(k=16), opts, partition=True)
    t = sched.submit("social", "edge_updates", edge_updates=(src, dst))
    sched.drain()
    assert t.done and t.result.halted
    print(sched.stats()["coalescing_factor"])
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import delta as _delta
from ..core import engine as _engine
from ..core.graph import Graph
from ..core.session import PartitionSession
from ..core.spinner import SpinnerConfig
from .requests import KINDS, Tenant, Ticket


class _Work(NamedTuple):
    """A prepared batchable window: the session's work item + its
    batch signature."""

    state: object
    bind: object
    cfg: object
    opts: object
    sig: tuple


class StagePrefetch:
    """Warm the NEXT queued snapshot rebind off the critical path.

    When a tenant's head-of-queue request is an ``adapt(new_graph=...)``,
    stage the snapshot now (``PartitionSession.stage`` builds the padded
    view and uploads it), so the eventual serial dispatch starts from
    device-resident arrays."""

    name = "stage_prefetch"

    def __init__(self) -> None:
        self.staged = 0

    def run(self, sched: "PartitionScheduler") -> None:
        for t in sched.tenants.values():
            if not t.queue:
                continue
            tk = t.queue[0]
            g = tk.payload.get("new_graph")
            if g is None or tk.payload.get("_staged"):
                continue
            t.session.stage(g)
            tk.payload["_staged"] = True
            self.staged += 1
            return                    # one staging per round

    def stats(self) -> dict:
        return {"staged": self.staged}


class KSweepPrecompile:
    """Scan the queues for ``resize`` targets, once per (tenant, k).

    The reference compiles the new-k program here, off the critical path.
    Eager PyTorch compiles nothing per k (the kernels build once per
    source), so the scan keeps its ``warmed`` set and ``compiled`` stays
    0: the policy is kept so a fleet's policy stats read the same.  What
    it does warm is the tile autotuner's pick at the new k (memoized per
    bucket), as the reference's warm resolves it."""

    name = "ksweep_precompile"

    def __init__(self) -> None:
        self.warmed: set = set()
        self.compiled = 0

    def run(self, sched: "PartitionScheduler") -> None:
        for t in sched.tenants.values():
            for tk in t.queue:
                if tk.kind != "resize":
                    continue
                key = (t.name, tk.payload["k"])
                if key in self.warmed:
                    continue
                self.warmed.add(key)
                sess = t.session
                if sess._mesh is None:
                    _engine._autotuned(sess._graph, dataclasses.replace(
                        sess.cfg, k=tk.payload["k"]), sess.options)
                return                # one (tenant, k) per round

    def stats(self) -> dict:
        return {"warmed": len(self.warmed), "compiled": self.compiled}


def default_policies() -> tuple:
    return (StagePrefetch(), KSweepPrecompile())


def default_batch_min() -> int:
    """Smallest same-bucket group worth batching on THIS host.

    A batched iteration does every element's work and runs until the
    slowest element halts, so batching pays only where the elements run
    in parallel -- a card, or a multicore CPU host.  On a single-core CPU
    host it is extra work, so the scheduler defaults to coalescing plus
    serial dispatch there; pass ``batch_min`` to force either path.
    """
    if (os.cpu_count() or 1) > 1 or torch.cuda.is_available():
        return 2
    return 10 ** 9


class PartitionScheduler:
    """Multi-tenant serving loop over :class:`PartitionSession`\\ s.

    ``max_batch`` bounds how many tenant windows one round dispatches
    (and so the widest batch); ``batch_min`` is the smallest group that
    takes the batched runner -- below it a window runs through
    ``engine.run_bound`` on its own work item (tests set ``batch_min=1``
    to force the batch-of-1 path).  It defaults to
    :func:`default_batch_min`.  ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(self, *, max_batch: int = 8,
                 batch_min: Optional[int] = None,
                 preempt_staleness: Optional[float] = None,
                 policies: Optional[Sequence] = None,
                 deployment=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.deployment = deployment
        self._recoveries = 0
        self.batch_min = max(1, default_batch_min() if batch_min is None
                             else batch_min)
        self.preempt_staleness = preempt_staleness
        self.policies = tuple(default_policies() if policies is None
                              else policies)
        self.clock = clock
        self.tenants: Dict[str, Tenant] = {}
        self._seq = 0
        self._retired_uploads = 0     # uploads of removed tenants' sessions
        self._mark = 0
        self._submitted = 0
        self._completed = 0
        self._errors = 0
        self._eu_folded = 0           # edge-update tickets folded ...
        self._delta_dispatches = 0    # ... into this many dispatches
        self._batched_dispatches = 0
        self._serial_dispatches = 0
        self._occupancy: List[float] = []
        self._batch_sizes: List[int] = []
        self._latencies: Dict[str, List[float]] = {}
        self._policy_errors: List[str] = []
        self._first_arrival: Optional[float] = None
        self._last_finish: Optional[float] = None

    # -- tenant lifecycle --------------------------------------------------

    def add_tenant(self, name: str, graph: Graph, cfg: SpinnerConfig,
                   options: Optional[_engine.EngineOptions] = None, *,
                   priority: float = 1.0,
                   partition: bool = False) -> Tenant:
        """Admit a tenant.  ``partition=True`` runs the cold first
        partition synchronously on admission (the O(E) upload is paid
        here, not inside the serving loop); otherwise the tenant's first
        request must be ``partition``."""
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if self.deployment is not None:
            options = self.deployment.admit(name, options)
        t = Tenant(name=name,
                   session=PartitionSession(graph, cfg, options),
                   priority=float(priority))
        self.tenants[name] = t
        if partition:
            t.session.partition(record_history=False)
        return t

    def remove_tenant(self, name: str) -> None:
        """Retire a tenant: fail its queued tickets, close its session
        (idempotent), fold its upload count into the scheduler's."""
        t = self.tenants.pop(name)
        now = self.clock()
        err = RuntimeError(f"tenant {name!r} retired with requests queued")
        while t.queue:
            tk = t.queue.popleft()
            tk.done, tk.error, tk.finish = True, err, now
            self._errors += 1
        self._retired_uploads += t.session.uploads
        t.session.close()

    # -- admission ---------------------------------------------------------

    def submit(self, tenant: str, kind: str, *, edge_updates=None,
               new_graph: Optional[Graph] = None, k: Optional[int] = None,
               frontier: bool = False,
               arrival: Optional[float] = None) -> Ticket:
        """Enqueue one request; returns its :class:`Ticket` (resolved in
        place by a later ``step``/``drain``)."""
        if kind not in KINDS:
            raise ValueError(f"unknown request kind {kind!r}; "
                             f"available: {', '.join(KINDS)}")
        t = self.tenants[tenant]
        payload: dict = {}
        if kind == "edge_updates":
            if edge_updates is None:
                raise ValueError("edge_updates request needs "
                                 "edge_updates=(src, dst)")
            payload["edge_updates"] = edge_updates
        elif kind == "resize":
            if k is None:
                raise ValueError("resize request needs k=")
            payload["k"] = int(k)
        elif kind == "adapt":
            if new_graph is not None:
                payload["new_graph"] = new_graph
            if frontier:
                payload["frontier"] = True
        now = self.clock() if arrival is None else arrival
        tk = Ticket(tenant=tenant, kind=kind, seq=self._seq, arrival=now,
                    payload=payload)
        self._seq += 1
        self._submitted += 1
        if self._first_arrival is None:
            self._first_arrival = now
        t.queue.append(tk)
        return tk

    # -- the dispatch loop -------------------------------------------------

    def step(self) -> int:
        """One dispatch round; returns the number of requests completed.

        Picks up to ``max_batch`` tenant windows by priority-weighted
        staleness, groups the batchable ones by batch signature, runs
        each group as one batched run (serial fallbacks and
        sub-``batch_min`` groups through ``run_bound`` or the sessions'
        own entry points), runs the prefetch policies, then commits the
        results and resolves every ticket in each window.
        """
        now = self.clock()
        ready = [t for t in self.tenants.values() if t.queue]
        if not ready:
            return 0
        ready.sort(key=lambda t: self._rank(t, now))
        take = ready[: self.max_batch]

        groups: Dict[tuple, list] = {}
        serial: list = []
        completed = 0
        for t in take:
            window = t.next_window()
            n_eu = sum(1 for tk in window if tk.kind == "edge_updates")
            if n_eu:
                self._eu_folded += n_eu
                self._delta_dispatches += 1
            try:
                work = self._prepare(t, window)
            except Exception as e:              # bad request: fail tickets
                completed += self._fail(t, window, e)
                continue
            if work is None:
                serial.append((t, window))
            else:
                groups.setdefault(work.sig, []).append((t, window, work))

        pending: list = []   # (tenant, window, out_state or error)
        for group in groups.values():
            if len(group) < self.batch_min:
                for t, window, work in group:
                    t.serial_dispatches += 1
                    self._serial_dispatches += 1
                    pending.append((t, window, self._guard(
                        _engine.run_bound, work.cfg, work.opts, work.state,
                        work.bind)))
                continue
            items = [(w.state, w.bind) for _, _, w in group]
            outs = self._guard(_engine.run_batched, items, group[0][2].cfg,
                               group[0][2].opts)
            self._batched_dispatches += 1
            self._occupancy.append(
                len(group) / _engine.batch_bucket(len(group)))
            self._batch_sizes.append(len(group))
            for i, (t, window, _w) in enumerate(group):
                t.batched_dispatches += 1
                pending.append((t, window, outs if isinstance(
                    outs, BaseException) else outs[i]))

        self._run_policies()

        for t, window, out in pending:
            try:
                if isinstance(out, BaseException):
                    raise out
                completed += self._finish(t, window,
                                          t.session.commit_adapt(out))
            except Exception as e:
                completed += self._resolve_failure(t, window, e)
        for t, window in serial:
            try:
                completed += self._finish(t, window,
                                          self._dispatch_serial(t, window))
            except Exception as e:
                completed += self._resolve_failure(t, window, e)
        return completed

    def drain(self, max_rounds: Optional[int] = None) -> int:
        """Run rounds until every queue is empty; returns completions."""
        completed = 0
        rounds = 0
        while any(t.queue for t in self.tenants.values()):
            if max_rounds is not None and rounds >= max_rounds:
                break
            completed += self.step()
            rounds += 1
        return completed

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _guard(fn, *args):
        """``fn(*args)``, or the exception it raised (resolved per window
        after the policies run, as the reference's dispatch errors)."""
        try:
            return fn(*args)
        except Exception as e:
            return e

    def _rank(self, t: Tenant, now: float) -> tuple:
        """Sort key (ascending): SLO-preempted first, then priority x
        staleness, then raw priority, then admission order."""
        stale = t.staleness(now)
        preempt = (self.preempt_staleness is not None
                   and stale >= self.preempt_staleness)
        return (not preempt, -(t.priority * stale), -t.priority,
                t.queue[0].seq)

    def _prepare(self, t: Tenant, window: List[Ticket]
                 ) -> Optional[_Work]:
        """A window's batched work item, or None for serial dispatch."""
        last = window[-1]
        if last.kind in ("partition", "resize"):
            return None
        if last.payload.get("new_graph") is not None \
                or last.payload.get("frontier"):
            return None
        if not t.session.batchable():
            return None
        eu = [tk.payload["edge_updates"] for tk in window
              if tk.kind == "edge_updates"]
        updates = _delta.coalesce_updates(eu) if eu else None
        parts = t.session.adapt_parts(edge_updates=updates)
        if parts is None:
            return None
        state, bind, cfg, opts = parts
        return _Work(state, bind, cfg, opts,
                     _engine.batch_signature(cfg, opts, bind))

    def _dispatch_serial(self, t: Tenant, window: List[Ticket]):
        """Run a non-batchable window through the session's own entry
        points (still coalesced: one adapt per window)."""
        sess = t.session
        last = window[-1]
        t.serial_dispatches += 1
        self._serial_dispatches += 1
        if last.kind == "partition":
            return sess.partition(record_history=False)
        if last.kind == "resize":
            return sess.resize(last.payload["k"], record_history=False)
        kw: dict = {"record_history": False}
        eu = [tk.payload["edge_updates"] for tk in window
              if tk.kind == "edge_updates"]
        if eu:
            kw["edge_updates"] = _delta.coalesce_updates(eu)
        if last.kind == "adapt":
            if last.payload.get("new_graph") is not None:
                kw["new_graph"] = last.payload["new_graph"]
            if last.payload.get("frontier"):
                kw["frontier"] = True
        return sess.adapt(**kw)

    def _run_policies(self) -> None:
        for p in self.policies:
            try:
                p.run(self)
            except Exception as e:    # prefetch must never fail serving
                self._policy_errors.append(
                    f"{getattr(p, 'name', type(p).__name__)}: {e!r}")

    def _finish(self, t: Tenant, window: List[Ticket], res) -> int:
        now = self.clock()
        for tk in window:
            tk.done, tk.result, tk.finish = True, res, now
            tk.coalesced = len(window)
            self._latencies.setdefault(tk.kind, []).append(tk.latency())
        t.completed += len(window)
        self._completed += len(window)
        self._last_finish = now
        if self.deployment is not None:
            self.deployment.after_commit(t.name, t.session)
        return len(window)

    def _resolve_failure(self, t: Tenant, window: List[Ticket],
                         err: BaseException) -> int:
        """A dispatch raised: under a deployment, recover the tenant from
        its newest snapshot and retry the window ONCE; otherwise (or when
        recovery cannot proceed) fail the tickets.  The recovery graph is
        the failed session's materialized logical graph -- base plus every
        accepted delta batch, INCLUDING this window's (``adapt_parts`` /
        ``adapt`` append to the pending log before dispatching) -- so the
        retry is a plain reconvergence: re-applying the window's edge
        updates would count them twice.  A resize committed after the
        newest snapshot is rolled forward by ``recover`` (not when the
        retried window is itself a resize, which sets k)."""
        if self.deployment is None:
            return self._fail(t, window, err)
        try:
            graph = t.session.graph       # materializes the delta log
            info = self.deployment.recover(
                t.name, graph, options=t.session.options,
                roll_forward_k=window[-1].kind != "resize")
            if info is None:              # no snapshot yet: fail normally
                return self._fail(t, window, err)
            old, t.session = t.session, info.session
            old.close()
            self._recoveries += 1
            last = window[-1]
            t.serial_dispatches += 1
            self._serial_dispatches += 1
            if last.kind == "partition":
                res = t.session.partition(record_history=False)
            elif last.kind == "resize":
                res = t.session.resize(last.payload["k"],
                                       record_history=False)
            else:
                kw: dict = {"record_history": False}
                if last.payload.get("new_graph") is not None:
                    kw["new_graph"] = last.payload["new_graph"]
                res = t.session.adapt(**kw)
            return self._finish(t, window, res)
        except Exception as e:
            return self._fail(t, window, e)

    def _fail(self, t: Tenant, window: List[Ticket],
              err: BaseException) -> int:
        """Fail a window's tickets (a bad request, or a dispatch that
        raised and was not recovered)."""
        now = self.clock()
        for tk in window:
            tk.done, tk.error, tk.finish = True, err, now
        t.failed += len(window)
        self._errors += len(window)
        return len(window)

    # -- upload tracking / stats -------------------------------------------

    @property
    def uploads(self) -> int:
        """O(E) uploads this scheduler's sessions caused, live or
        retired (the port's counterpart of the reference's compiles)."""
        return self._retired_uploads + sum(
            t.session.uploads for t in self.tenants.values())

    def mark(self) -> None:
        """Snapshot the upload counter; ``stats()["uploads_since_mark"]``
        then measures steady-state uploads (0 for a warm fleet)."""
        self._mark = self.uploads

    def stats(self) -> dict:
        """Serving metrics: latency percentiles, throughput, coalescing
        factor, batch occupancy, upload counters, per-policy stats."""

        def pct(xs: List[float], q: float) -> float:
            if not xs:
                return float("nan")
            ys = sorted(xs)
            return ys[min(int(q * len(ys)), len(ys) - 1)]

        def summary(xs: List[float]) -> dict:
            return {"p50": pct(xs, 0.50), "p99": pct(xs, 0.99),
                    "mean": float(np.mean(xs)) if xs else float("nan"),
                    "count": len(xs)}

        lat_all = [x for xs in self._latencies.values() for x in xs]
        lat_adapt = (self._latencies.get("edge_updates", [])
                     + self._latencies.get("adapt", []))
        span = ((self._last_finish - self._first_arrival)
                if self._last_finish is not None
                and self._first_arrival is not None else 0.0)
        uploads = self.uploads
        return {
            "tenants": len(self.tenants),
            "submitted": self._submitted,
            "completed": self._completed,
            "errors": self._errors,
            "queued": sum(len(t.queue) for t in self.tenants.values()),
            "throughput_rps": (self._completed / span if span > 0
                               else float("nan")),
            "latency": summary(lat_all),
            "adapt_latency": summary(lat_adapt),
            "coalescing_factor": (self._eu_folded
                                  / max(self._delta_dispatches, 1)),
            "batched_dispatches": self._batched_dispatches,
            "serial_dispatches": self._serial_dispatches,
            "batch_occupancy": (float(np.mean(self._occupancy))
                                if self._occupancy else 0.0),
            "mean_batch_size": (float(np.mean(self._batch_sizes))
                                if self._batch_sizes else 0.0),
            "uploads": uploads,
            "uploads_since_mark": uploads - self._mark,
            "policies": {getattr(p, "name", type(p).__name__):
                         (p.stats() if hasattr(p, "stats") else {})
                         for p in self.policies},
            "policy_errors": list(self._policy_errors),
            "recoveries": self._recoveries,
            "deployment": (self.deployment.stats()
                           if self.deployment is not None else None),
        }
