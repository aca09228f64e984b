"""Request/queue layer of the multi-tenant serving tier.

A :class:`Ticket` is the handle returned by ``PartitionScheduler.submit``
for one request against one tenant's graph; a :class:`Tenant` pairs a
named :class:`~repro_torch.core.session.PartitionSession` with its FIFO
admission queue and per-tenant counters.  The port's copy of the
reference's ``repro.serve.requests``, with the same coalescing rule.

Dispatch is window-based: ``Tenant.next_window`` pops the unit one device
dispatch serves -- the longest leading run of ``edge_updates`` requests
plus (when one immediately follows) a single plain ``adapt``.  All
requests in a window complete with the SAME result:
``delta.coalesce_updates`` folds the queued batches into one
direction-aware delta that produces bit-identical labels to applying
them one by one and reconverging once, so N queued edge-update requests
cost one ``apply_delta`` scatter plus one reconvergence (the coalescing
the scheduler's ``coalescing_factor`` measures).  ``partition``/``resize`` requests -- and adapts that rebind
to a new graph or ask for frontier reconvergence -- dispatch alone.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, List, Optional

#: Request kinds the scheduler admits.
KINDS = ("partition", "edge_updates", "adapt", "resize")


@dataclasses.dataclass
class Ticket:
    """Handle for one submitted request (resolved in place on dispatch)."""

    tenant: str
    kind: str                     # one of KINDS
    seq: int                      # global admission order
    arrival: float                # scheduler-clock submission time
    payload: dict = dataclasses.field(default_factory=dict)
    done: bool = False
    result: object = None         # PartitionResult on success
    error: Optional[BaseException] = None
    finish: float = math.nan
    coalesced: int = 0            # requests served by the same dispatch

    @property
    def failed(self) -> bool:
        return self.error is not None

    def latency(self) -> float:
        """Seconds from admission to completion (NaN while queued)."""
        return self.finish - self.arrival


@dataclasses.dataclass
class Tenant:
    """One served graph: a session, its admission queue, its counters."""

    name: str
    session: object               # PartitionSession
    priority: float = 1.0
    queue: Deque[Ticket] = dataclasses.field(default_factory=deque)
    completed: int = 0
    failed: int = 0
    batched_dispatches: int = 0
    serial_dispatches: int = 0

    def next_window(self) -> List[Ticket]:
        """Pop the next dispatch unit off the queue (empty list if idle).

        ``edge_updates`` at the head absorb every directly following
        ``edge_updates`` plus at most one plain ``adapt`` (no new graph
        -- a rebind supersedes queued deltas rather than absorbing
        them); anything else dispatches alone.  FIFO order within the
        tenant is preserved, so coalescing never reorders a tenant's
        own requests.
        """
        q = self.queue
        if not q:
            return []
        window = [q.popleft()]
        if window[0].kind == "edge_updates":
            while q and q[0].kind == "edge_updates":
                window.append(q.popleft())
            if q and q[0].kind == "adapt" \
                    and q[0].payload.get("new_graph") is None:
                window.append(q.popleft())
        return window

    def staleness(self, now: float) -> float:
        """Age of the oldest queued request (0.0 when idle)."""
        return (now - self.queue[0].arrival) if self.queue else 0.0
