"""Spans inside the port: where a call's time goes, layer by layer.

One tracer for the whole package.  ``span(name, device=False, n=None)``
marks a stretch of work at a layer boundary::

    from repro_torch.runtime import trace

    with trace.span("delta.ledger", n=pairs):
        plan = tracker.plan(src, dst)

A span opened inside another records that span as its parent, and every
span under one root (``session.partition``, ``session.adapt``) shares the
root's call id.  ``n`` is an optional count of the items the span handled
(pairs, entries).

**Off** is the default: a span then costs one check of this module's flag
and one of ``torch.autograd.profiler._is_profiler_enabled``, and returns a
shared do-nothing context (no allocation, no ``record_function``, no CUDA
event, no synchronisation).

**On** while a ``torch.profiler`` session records or a ``recording()``
block is open.  Each span then

* enters ``torch.profiler.record_function(name)`` when a profiler is
  active, so the spans sit in the profiler's trace around the kernels they
  launch, on its clock;
* appends a ``Record`` to a bounded in-memory ring (``RING`` records, the
  oldest dropped first): name, id, parent id, call id, ``perf_counter_ns``
  start and end, ``n``;
* with ``device`` (``True``: the current CUDA device once CUDA is up; or a
  ``torch.device``, a CPU one records nothing), records a pair of timing
  CUDA events on the current stream around it.

Nothing synchronises while a span runs.  ``records()`` and ``snapshot()``
synchronise once and resolve the events: a record's ``device_ms`` is the
stream time between its two events, ``None`` without them.  ``reset()``
clears the ring.  There is no file exporter: the timeline is the
profiler's, the totals are ``snapshot()``'s.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["RING", "Record", "span", "recording", "records", "snapshot",
           "reset"]

RING = 65536

_on = False                 # a recording() block is open
_depth = 0                  # nesting of recording() blocks
_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans
_lock = threading.Lock()


class Record:
    """One closed span.  ``host_ms`` is its host duration; ``device_ms``
    the stream time between its events once resolved (``None`` when it
    recorded none)."""

    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns", "n",
                 "device_ms", "_events")

    def __init__(self, name: str, id: int, parent: Optional[int],
                 call: int, n: Optional[int]):
        self.name, self.id, self.parent, self.call = name, id, parent, call
        self.n = n
        self.start_ns = self.end_ns = 0
        self.device_ms: Optional[float] = None
        self._events = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, id={self.id}, parent={self.parent}, "
                f"call={self.call}, host_ms={self.host_ms:.3f}, "
                f"device_ms={self.device_ms}, n={self.n})")


class _Off:
    """The span while tracing is off: one shared instance, does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _cuda_stream(device):
    """The current stream of the CUDA device ``device`` names, or None
    when it names none (the CPU, or ``True`` before CUDA is up)."""
    if device is True:
        if not torch.cuda.is_initialized():
            return None
        return torch.cuda.current_stream()
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.current_stream(device)


class _Span:
    __slots__ = ("_rec", "_fn", "_stream")

    def __init__(self, name: str, device, n: Optional[int]):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rid = next(_ids)
        parent = stack[-1] if stack else None
        self._rec = Record(name, rid, parent.id if parent else None,
                           parent.call if parent else rid,
                           None if n is None else int(n))
        self._fn = None
        self._stream = (_cuda_stream(device)
                        if device is not False and device is not None
                        else None)

    def __enter__(self):
        rec = self._rec
        _local.stack.append(rec)
        if _autograd_profiler._is_profiler_enabled:
            self._fn = torch.profiler.record_function(rec.name)
            self._fn.__enter__()
        if self._stream is not None:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record(self._stream)
            rec._events = (ev0, None, self._stream.device)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self._rec
        if self._stream is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(self._stream)
            rec._events = (rec._events[0], ev1, rec._events[2])
        rec.end_ns = time.perf_counter_ns()
        if self._fn is not None:
            self._fn.__exit__(None, None, None)
        _local.stack.pop()
        _ring.append(rec)
        return False


def span(name: str, device=False, n: Optional[int] = None):
    """The context of one span (see the module docstring); a shared no-op
    while tracing is off."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, n)


@contextmanager
def recording():
    """Trace inside the block, with or without a profiler."""
    global _on, _depth
    with _lock:
        _depth += 1
        _on = True
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            _on = _depth > 0


def records() -> List[Record]:
    """The ring's records, oldest first, their device times resolved
    (one synchronisation of each device that has events pending)."""
    recs = list(_ring)
    pending = [r for r in recs if r._events is not None]
    if pending:
        for dev in {r._events[2] for r in pending}:
            torch.cuda.synchronize(dev)
        for r in pending:
            ev0, ev1, _ = r._events
            r.device_ms = ev0.elapsed_time(ev1)
            r._events = None
    return recs


def snapshot() -> Dict[str, dict]:
    """Totals by span name over the ring: ``calls``, ``host_ms``,
    ``self_ms`` (host time less the children's), ``device_ms`` (``None``
    without device events) and ``n`` (``None`` without counts)."""
    recs = records()
    children_ns: Dict[int, int] = collections.defaultdict(int)
    for r in recs:
        if r.parent is not None:
            children_ns[r.parent] += r.end_ns - r.start_ns
    out: Dict[str, dict] = {}
    for r in recs:
        s = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                    "self_ms": 0.0, "device_ms": None,
                                    "n": None})
        s["calls"] += 1
        s["host_ms"] += r.host_ms
        s["self_ms"] += (r.end_ns - r.start_ns - children_ns[r.id]) * 1e-6
        if r.device_ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
        if r.n is not None:
            s["n"] = (s["n"] or 0) + r.n
    return out


def reset() -> None:
    """Drop every record."""
    _ring.clear()
