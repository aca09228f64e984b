"""The port's tracer (``repro_torch.runtime.trace``) and its spans.

Off (the default) a span records nothing and enters no
``record_function``; on, under ``trace.recording()`` or a
``torch.profiler`` session, every span on the main paths of
``partition`` and ``adapt(edge_updates=...)`` is recorded with its parent
and call id, and appears in the profiler's events inside the caller's
own ranges.  The last test needs a CUDA card (marker ``gpu``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (EngineOptions, SpinnerConfig, generators,
                              open_session)
from repro_torch.runtime import trace

N, K, PAIRS, ADAPTS = 1500, 4, 24, 3
PARTITION_SPANS = {"session.partition", "draws", "kernels.k1",
                   "runner.epilogue", "runner.readback"}
ADAPT_SPANS = {"session.adapt", "delta.ledger", "delta.merge",
               "session.restart", "draws", "kernels.k1", "runner.epilogue",
               "runner.readback"}
ROOTS = ("session.partition", "session.adapt")


def _session(device="cpu"):
    g = generators.watts_strogatz(N, 6, 0.3, seed=1)
    return open_session(g, SpinnerConfig(k=K, seed=3),
                        EngineOptions(engine="fused", device=device))


def _batches():
    rng = np.random.default_rng(5)
    return [(rng.integers(0, N, PAIRS), rng.integers(0, N, PAIRS))
            for _ in range(ADAPTS)]


def _calls(session, batches):
    """A partition and ``len(batches)`` adapts: their results."""
    out = [session.partition()]
    for src, dst in batches:
        out.append(session.adapt(edge_updates=(src, dst)))
    return out


@pytest.fixture(scope="module")
def traced():
    """A tiny session's partition and three adapts under ``recording()``:
    ``(results, records by call, roots)``."""
    trace.reset()
    with _session() as s, trace.recording():
        results = _calls(s, _batches())
        assert s.stats()["delta"]["fast_adapts"] == ADAPTS
    recs = trace.records()
    trace.reset()
    roots = [r for r in recs if r.parent is None]
    by_call = {r.id: [x for x in recs if x.call == r.id] for r in roots}
    return results, by_call, roots


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered, events = [], []
    real_rf, real_event = torch.profiler.record_function, torch.cuda.Event
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **kw: entered.append(a) or real_rf(*a))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **kw: events.append(a)
                        or real_event(*a, **kw))
    trace.reset()
    with _session() as s:
        _calls(s, _batches()[:1])
    assert trace.records() == [] and trace.snapshot() == {}
    assert entered == [] and events == []


def test_off_span_is_one_shared_object():
    a = trace.span("draws", device=True, n=3)
    b = trace.span("delta.ledger")
    assert a is b
    with a as got:
        assert got is None
    assert trace.records() == []


def test_roots_are_the_two_session_calls(traced):
    results, by_call, roots = traced
    assert [r.name for r in roots] == ["session.partition"] \
        + ["session.adapt"] * ADAPTS
    for root in roots:
        assert root.call == root.id


@pytest.mark.parametrize("call", range(ADAPTS + 1))
def test_every_span_under_its_root(traced, call):
    results, by_call, roots = traced
    root = roots[call]
    recs = by_call[root.id]
    want = PARTITION_SPANS if call == 0 else ADAPT_SPANS
    assert {r.name for r in recs} == want
    for r in recs:
        assert r.call == root.id
        # every program span sits directly under its session call
        assert r.parent == (None if r is root else root.id), r
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns


@pytest.mark.parametrize("call", range(ADAPTS + 1))
def test_draws_and_epilogue_once_per_iteration(traced, call):
    results, by_call, roots = traced
    recs = by_call[roots[call].id]
    iters = results[call].iterations
    assert iters > 0
    for name in ("draws", "kernels.k1", "runner.epilogue"):
        assert sum(r.name == name for r in recs) == iters, name


def test_ledger_and_merge_counts(traced):
    results, by_call, roots = traced
    for root in roots[1:]:
        recs = by_call[root.id]
        ledger = [r for r in recs if r.name == "delta.ledger"]
        merge = [r for r in recs if r.name == "delta.merge"]
        restart = [r for r in recs if r.name == "session.restart"]
        assert len(ledger) == 2 and all(r.n == PAIRS for r in ledger)
        # two directed entries a changed pair, at most the pairs handed in
        assert len(merge) == 1 and 0 < merge[0].n <= 2 * PAIRS
        assert merge[0].n % 2 == 0
        assert len(restart) == 2


def test_self_time_within_duration(traced):
    results, by_call, roots = traced
    for recs in by_call.values():
        for r in recs:
            kids = sum(x.end_ns - x.start_ns for x in recs
                       if x.parent == r.id)
            assert 0 <= kids <= r.end_ns - r.start_ns
            assert r.device_ms is None          # the CPU: no events


def test_snapshot_totals():
    trace.reset()
    with _session() as s, trace.recording():
        res = s.partition()
    snap = trace.snapshot()
    trace.reset()
    assert set(snap) == PARTITION_SPANS
    for name, tot in snap.items():
        assert 0.0 <= tot["self_ms"] <= tot["host_ms"] + 1e-9, name
        assert tot["device_ms"] is None
    assert snap["draws"]["calls"] == res.iterations
    assert snap["session.partition"]["calls"] == 1
    assert snap["session.partition"]["self_ms"] < \
        snap["session.partition"]["host_ms"]


def test_spans_nest_in_the_profilers_events():
    from torch.profiler import ProfilerActivity, profile, record_function

    trace.reset()
    with _session() as s:
        s.partition()            # warm
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("outer"):
                s.adapt(edge_updates=_batches()[0])
    # the profiler turned the spans on without recording()
    assert {r.name for r in trace.records()} == ADAPT_SPANS
    trace.reset()
    events = prof.events()
    outer = [e for e in events if e.name == "outer"]
    assert len(outer) == 1
    o = outer[0].time_range
    seen = set()
    for e in events:
        if e.name in ADAPT_SPANS:
            seen.add(e.name)
            assert o.start <= e.time_range.start <= e.time_range.end <= o.end
            up, names = e.cpu_parent, []
            while up is not None:
                names.append(up.name)
                up = up.cpu_parent
            assert names[-1] == "outer", (e.name, names)
            if e.name != "session.adapt":
                assert names[0] == "session.adapt", (e.name, names)
    assert seen == ADAPT_SPANS


def test_recording_nests_and_turns_off():
    trace.reset()
    with trace.recording():
        with trace.recording():
            with trace.span("a"):
                pass
        with trace.span("b", n=7):
            with trace.span("c", device=torch.device("cpu")):
                pass
    with trace.span("d"):
        pass
    recs = trace.records()
    trace.reset()
    assert [r.name for r in recs] == ["a", "c", "b"]
    a, c, b = recs
    assert a.parent is None and a.call == a.id
    assert c.parent == b.id and c.call == b.id and b.n == 7
    assert all(r.device_ms is None for r in recs)


def test_ring_drops_the_oldest():
    trace.reset()
    extra = 5
    with trace.recording():
        for i in range(trace.RING + extra):
            with trace.span("s", device=True, n=i):
                pass
    recs = trace.records()
    trace.reset()
    assert len(recs) == trace.RING
    assert recs[0].n == extra and recs[-1].n == trace.RING + extra - 1
    assert all(r.device_ms is None for r in recs)    # no card: no events


def test_span_records_on_an_exception():
    trace.reset()
    with trace.recording():
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise ValueError("x")
        with trace.span("after"):
            pass
    recs = trace.records()
    trace.reset()
    assert [r.name for r in recs] == ["inner", "outer", "after"]
    assert recs[2].parent is None


@pytest.mark.gpu
def test_device_spans_time_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    trace.reset()
    with _session(device="cuda") as s, trace.recording():
        res = s.partition()
        s.adapt(edge_updates=_batches()[0])
    snap = trace.snapshot()
    recs = trace.records()
    trace.reset()
    for name in ("runner.epilogue", "kernels.k1", "draws"):
        timed = [r for r in recs if r.name == name]
        assert len(timed) >= res.iterations
        assert all(r.device_ms is not None and r.device_ms > 0
                   for r in timed), name
        assert snap[name]["device_ms"] > 0
    for name in ("session.partition", "delta.ledger", "runner.readback"):
        assert snap[name]["device_ms"] is None
