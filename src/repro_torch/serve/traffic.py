"""Synthetic open-loop traffic for the serving tier (bench + tests).

Models the workload Spinner positions itself for (§ dynamicity): many
independent graphs served from one process, each emitting a continuous
stream of small edge deltas with occasional full reconvergence and
cluster-resize requests.  Tenant graph sizes follow a truncated power
law (a few big graphs, a long tail of small ones -- the multi-tenant
cloud shape); arrivals are a per-tenant Poisson process of BURSTS, each
burst holding a geometric number of back-to-back requests.  Bursts are
what make delta coalescing pay: several edge-update requests land in a
tenant's queue between two scheduler rounds and fold into one
``apply_delta`` plan (``stats()["coalescing_factor"] > 1``).

The port's copy of the reference's ``repro.serve.traffic``: for the same
seed the sizes, batches and traces are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def powerlaw_sizes(n: int, v_min: int = 256, v_max: int = 4096,
                   alpha: float = 2.2, seed: int = 0) -> List[int]:
    """``n`` vertex counts from a truncated Pareto (inverse-CDF draw)."""
    rng = np.random.default_rng(seed)
    a = 1.0 - float(alpha)
    u = rng.random(n)
    xs = (v_min ** a + u * (v_max ** a - v_min ** a)) ** (1.0 / a)
    return [int(x) for x in xs]


def tenant_graph(num_vertices: int, seed: int = 0, k_nbrs: int = 8):
    """A small-world tenant graph (the bench's per-tenant topology)."""
    from ..core.generators import watts_strogatz
    return watts_strogatz(num_vertices, k_nbrs, 0.1, seed=seed)


def random_edge_updates(num_vertices: int, n_edges: int,
                        rng: np.random.Generator
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """A random non-self-loop ``(src, dst)`` delta batch."""
    src = rng.integers(0, num_vertices, n_edges)
    dst = rng.integers(0, num_vertices, n_edges)
    mask = src != dst
    if not mask.any():                      # degenerate tiny graph draw
        return (np.asarray([0], np.int64),
                np.asarray([num_vertices - 1], np.int64))
    return src[mask], dst[mask]


@dataclasses.dataclass
class TraceEvent:
    """One request arrival in an open-loop trace."""

    t: float                 # seconds from trace start
    tenant: str
    kind: str                # "edge_updates" | "adapt" | "resize"
    payload: dict = dataclasses.field(default_factory=dict)


def poisson_trace(tenants: Dict[str, int], *, duration: float,
                  rate: float, burst_mean: float = 3.0,
                  mix: Sequence[float] = (0.8, 0.15, 0.05),
                  edges_per_update: int = 16,
                  k_choices: Optional[Sequence[int]] = None,
                  seed: int = 0) -> List[TraceEvent]:
    """Bursty per-tenant Poisson arrivals, merged and time-sorted.

    ``tenants`` maps tenant name -> vertex count (delta batches are drawn
    against it); ``rate`` is bursts/second per tenant; each burst holds
    ``Geometric(1/burst_mean)`` requests arriving at the same instant.
    ``mix`` gives the (edge_updates, adapt, resize) probabilities; resize
    targets cycle through ``k_choices`` (omit for no resizes regardless
    of mix).
    """
    mix = np.asarray(mix, float)
    mix = mix / mix.sum()
    events: List[TraceEvent] = []
    for i, (name, num_vertices) in enumerate(sorted(tenants.items())):
        rng = np.random.default_rng((seed, i))
        t = 0.0
        while True:
            t += rng.exponential(1.0 / rate)
            if t >= duration:
                break
            for _ in range(int(rng.geometric(1.0 / max(burst_mean, 1.0)))):
                kind = ("edge_updates", "adapt", "resize")[
                    rng.choice(3, p=mix)]
                if kind == "edge_updates":
                    src, dst = random_edge_updates(
                        num_vertices, edges_per_update, rng)
                    payload = {"edge_updates": (src, dst)}
                elif kind == "resize":
                    if not k_choices:
                        kind, payload = "adapt", {}
                    else:
                        payload = {"k": int(rng.choice(k_choices))}
                else:
                    payload = {}
                events.append(TraceEvent(t, name, kind, payload))
    events.sort(key=lambda e: (e.t, e.tenant))
    return events


def replay(scheduler, events: Sequence[TraceEvent],
           time_scale: float = 1.0) -> int:
    """Open-loop replay: submit each event at its (scaled) trace time and
    run scheduler rounds whenever the queue is non-empty; returns the
    number of completed requests.  Arrival timestamps come from the
    scheduler's own clock, so latency percentiles include queueing
    delay, which is the point of an open-loop harness: a slow scheduler
    cannot push back on the trace.
    """
    import time as _time
    completed = 0
    t0 = scheduler.clock()
    i = 0
    n = len(events)
    while i < n or any(t.queue for t in scheduler.tenants.values()):
        now = (scheduler.clock() - t0) / time_scale
        while i < n and events[i].t <= now:
            e = events[i]
            scheduler.submit(e.tenant, e.kind, **e.payload)
            i += 1
        done = scheduler.step()
        completed += done
        if done == 0 and i < n:
            # idle until the next arrival (scaled back to wall time)
            _time.sleep(min(max(events[i].t * time_scale
                                - (scheduler.clock() - t0), 0.0), 0.01))
    return completed
