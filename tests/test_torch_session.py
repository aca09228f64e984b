"""The port's ``PartitionSession`` against the reference's, on the CPU.

Each case runs the same calls with the same seeds and batches through
``repro.core.open_session`` (XLA backend; Pallas in interpret mode once)
and ``repro_torch.core.open_session`` (``device="cpu"``; the CUDA
backend's plain versions and the torch scatter oracle).  Labels, loads,
iterations, halted, ``scored_per_iter`` and the ``stats()["delta"]``
counters must be identical -- the delta upload bytes aside, which follow
each package's layout.  The warm fast path must cause no O(E) upload and
no host rebuild.  Also: the graph edits and relabelings against the
reference's arrays, ``resize`` up and down, ``partition()`` through the
throwaway session, the closed-session error, and reference labels
carried across through ``repro_torch.convert``.
"""
import numpy as np
import pytest

from repro.core import EngineOptions as RefOptions
from repro.core import SpinnerConfig as RefConfig
from repro.core import add_edges as ref_add_edges
from repro.core import delta as ref_delta
from repro.core import from_edges as ref_from_edges
from repro.core import open_session as ref_open
from repro.core import partition as ref_partition
from repro.core import shape_bucket
from repro.core.generators import clustered_graph
from repro.core.graph import remove_vertices as ref_remove_vertices
from repro.core.incremental import elastic_relabel as ref_elastic
from repro.core.incremental import extend_labels as ref_extend
from repro.core.incremental import resize as ref_resize
from repro_torch.convert import graph_from_reference, state_from_reference
from repro_torch.core import (EngineOptions, SpinnerConfig, add_edges,
                              adapt, delta, elastic_relabel, extend_labels,
                              open_session, partition, remove_vertices,
                              resize)
from repro_torch.core.session import _CLOSED_MSG

# port (backend, fused_update) variants held to the reference's XLA runs
BACKENDS = [("cuda", "auto"), ("torch", "auto")]
COUNTERS = ("watermark", "pending_batches", "merged_batches", "fast_adapts",
            "fallback_adapts", "host_rebuilds", "tracked_total_weight")


@pytest.fixture(scope="module")
def base_graph():
    """A random directed-edge graph (mixed w=1/w=2 Eq. 3 weights)."""
    rng = np.random.default_rng(0)
    V, E = 600, 2400
    return ref_from_edges(rng.integers(0, V, E), rng.integers(0, V, E),
                          num_vertices=V)


@pytest.fixture(scope="module")
def fixed_point_graph():
    """Planted communities: LPA reaches a true fixed point."""
    return clustered_graph(4, 150, p_in=0.2, p_out_edges_per_v=0.05, seed=2)


def _opts(backend="cuda", fused="auto", **kw):
    return EngineOptions(device="cpu", score_backend=backend,
                         fused_update=fused, **kw)


class Twin:
    """One call sequence through both packages' sessions."""

    def __init__(self, g_ref, cfg: dict, ref_opts=None, opts=None):
        self.ref = ref_open(g_ref, RefConfig(**cfg),
                            ref_opts or RefOptions(engine="fused"))
        self.port = open_session(graph_from_reference(g_ref),
                                 SpinnerConfig(**cfg),
                                 opts or _opts(engine="fused"))

    def call(self, name, *args, **kw):
        r = getattr(self.ref, name)(*args, **kw)
        p = getattr(self.port, name)(*args, **kw)
        if name in ("update", "stage"):
            return r, p
        _same(p, r)
        return r, p

    def same_counters(self):
        rd, pd = self.ref.stats()["delta"], self.port.stats()["delta"]
        for key in COUNTERS:
            assert pd[key] == rd[key], key
        return pd


def _same(port, ref):
    np.testing.assert_array_equal(port.labels, np.asarray(ref.labels))
    np.testing.assert_array_equal(port.loads, np.asarray(ref.loads))
    assert port.iterations == ref.iterations
    assert port.halted == ref.halted
    assert port.scored_per_iter == ref.scored_per_iter
    assert port.scored_vertices == ref.scored_vertices
    assert port.exchanged_bytes == ref.exchanged_bytes == 0.0


# ---------------------------------------------------------------------------
# graph edits and relabelings
# ---------------------------------------------------------------------------

def _same_graph(port, ref):
    assert port.num_vertices == ref.num_vertices
    for f in ("src", "dst", "weight", "row_ptr", "deg_w"):
        np.testing.assert_array_equal(getattr(port, f),
                                      np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("directed", [True, False])
def test_add_edges_matches_reference(base_graph, directed):
    g = graph_from_reference(base_graph)
    rng = np.random.default_rng(5)
    V = base_graph.num_vertices
    u = int(base_graph.src[base_graph.weight == 1][0])
    w = int(base_graph.dst[base_graph.weight == 1][0])
    src = np.concatenate([rng.integers(0, V + 4, 60), [w, 3]])
    dst = np.concatenate([rng.integers(0, V, 60), [u, 3]])
    for nv in (None, V + 9):
        _same_graph(add_edges(g, src, dst, directed=directed,
                              num_vertices=nv),
                    ref_add_edges(base_graph, src, dst, directed=directed,
                                  num_vertices=nv))
    _same_graph(add_edges(g, [], []), ref_add_edges(base_graph, [], []))


def test_remove_vertices_matches_reference(base_graph):
    g = graph_from_reference(base_graph)
    drop = np.random.default_rng(6).choice(base_graph.num_vertices, 50,
                                           replace=False)
    _same_graph(remove_vertices(g, drop),
                ref_remove_vertices(base_graph, drop))


@pytest.mark.parametrize("k_old,k_new", [(4, 4), (4, 7), (8, 3)])
def test_relabelings_match_reference(k_old, k_new):
    prev = np.random.default_rng(k_new).integers(0, k_old, 500).astype(
        np.int32)
    np.testing.assert_array_equal(
        elastic_relabel(prev, k_old, k_new, seed=3),
        ref_elastic(prev, k_old, k_new, seed=3))
    np.testing.assert_array_equal(extend_labels(prev, 530),
                                  ref_extend(prev, 530))
    with pytest.raises(ValueError, match="remove_vertices"):
        extend_labels(prev, 10)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

V600 = 600
BAD_UPDATES = [
    ("update", ([1, 2, 3], [4, 5]), {}, "length"),
    ("update", ([1, -2], [3, 4]), {}, "negative"),
    ("update", ([1, V600], [3, 4]), {}, "vertices"),
    ("update", (np.array([1.5, 2.0]), np.array([3, 4])), {}, "integer"),
    ("update", (np.zeros((2, 2), np.int32), np.zeros((2, 2), np.int32)), {},
     "1-D"),
    ("adapt", (), {"edge_updates": ([1], [-1])}, "negative"),
    ("stage", (), {"edge_updates": ([1, 2], [3])}, "length"),
]


@pytest.mark.parametrize("method,args,kw,match", BAD_UPDATES)
def test_edge_update_validation(base_graph, method, args, kw, match):
    cfg = dict(k=3, max_iters=7, seed=1)
    t = Twin(base_graph, cfg)
    if method == "adapt":
        t.call("partition")
    errors = []
    for s in (t.ref, t.port):
        with pytest.raises(ValueError, match=match) as info:
            getattr(s, method)(*args, **kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert t.port.delta_watermark == t.ref.delta_watermark


def test_growth_and_direct_checks(base_graph):
    t = Twin(base_graph, dict(k=3, max_iters=7, seed=1))
    V = base_graph.num_vertices
    t.call("update", [1, V], [3, 4], num_vertices=V + 1)
    assert t.port.graph.num_vertices == t.ref.graph.num_vertices == V + 1
    _same_graph(t.port.graph, t.ref.graph)
    src, dst = delta.check_edge_updates([0, 1], [1, 2], 3)
    assert src.dtype == np.int32 and dst.dtype == np.int32
    for mod in (delta, ref_delta):
        with pytest.raises(ValueError):
            mod.check_edge_updates([0], [5], 3)
        mod.check_edge_updates([0], [5], 3, new_num_vertices=6)


# ---------------------------------------------------------------------------
# the data path: the on-device delta merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,fused", BACKENDS)
def test_warm_delta_no_upload_no_rebuild(base_graph, backend, fused):
    cfg = dict(k=4, max_iters=37, seed=3)
    opts = _opts(backend, fused, engine="fused")
    t = Twin(base_graph, cfg, opts=opts)
    _, p0 = t.call("partition")
    assert t.port.stats()["uploads"] == 1
    rng = np.random.default_rng(1)
    V = base_graph.num_vertices
    full_bytes = 12 * base_graph.num_directed_entries
    fast = []
    for n_fast in (1, 2):
        b = (rng.integers(0, V, 16), rng.integers(0, V, 16))
        _, p = t.call("adapt", edge_updates=b)
        fast.append((b, p))
        d = t.same_counters()
        assert d["fast_adapts"] == n_fast and d["host_rebuilds"] == 0
        assert d["fallback_adapts"] == 0
        assert 0 < d["last_upload_bytes"] < full_bytes // 10
        assert t.port.stats()["uploads"] == 1       # no O(E) re-upload
    # the oracle: each batch's rebuilt graph in a fresh session
    g, prev = graph_from_reference(base_graph), p0.labels
    for b, p in fast:
        g = add_edges(g, *b)
        o = open_session(g, SpinnerConfig(**cfg), opts).adapt(prev=prev)
        _same(p, o)
        prev = o.labels


def test_duplicates_reverse_upgrades_self_loops(base_graph):
    cfg = dict(k=4, max_iters=31, seed=5)
    t = Twin(base_graph, cfg)
    t.call("partition")
    w = np.asarray(base_graph.weight)
    src, dst = np.asarray(base_graph.src), np.asarray(base_graph.dst)
    one = np.flatnonzero((w == 1) & (src != dst))[0]
    u, v = int(src[one]), int(dst[one])
    batch = (np.array([u, u, v, 7, 9, 9, 11], np.int64),
             np.array([v, v, u, 7, 10, 10, 12], np.int64))
    t.call("adapt", edge_updates=batch)
    d = t.same_counters()
    assert d["fast_adapts"] == 1
    assert d["tracked_total_weight"] == \
        ref_add_edges(base_graph, *batch).total_weight


def test_overflow_falls_back():
    V = 500
    g = ref_from_edges(np.arange(V - 1), np.arange(1, V), num_vertices=V,
                       directed=False)   # path graph: tiny slack
    slack = shape_bucket(g.num_directed_entries) - g.num_directed_entries
    batch = (np.arange(0, V - 2), np.arange(2, V))
    assert 2 * (V - 2) > slack
    t = Twin(g, dict(k=4, max_iters=29, seed=7))
    t.call("partition")
    t.call("adapt", edge_updates=batch)
    d = t.same_counters()
    assert d["fast_adapts"] == 0 and d["fallback_adapts"] == 1
    assert d["host_rebuilds"] >= 1


@pytest.mark.parametrize("frontier", [None, True])
def test_vertex_growth_falls_back(base_graph, frontier):
    """A growing batch rebuilds; with ``frontier`` the fallback's active
    set is the batch's endpoints plus the new vertices."""
    t = Twin(base_graph, dict(k=4, max_iters=23, seed=9))
    V = base_graph.num_vertices
    t.call("partition")
    batch = (np.array([1, V + 2]), np.array([V, V + 1]))
    t.call("adapt", edge_updates=batch, num_vertices=V + 3,
           frontier=frontier)
    assert t.port.graph.num_vertices == V + 3
    d = t.same_counters()
    assert d["fast_adapts"] == 0 and d["host_rebuilds"] == 1
    assert t.port.stats()["uploads"] == 2


def test_update_pending_log_chains_with_fast_adapt(base_graph):
    t = Twin(base_graph, dict(k=4, max_iters=43, seed=11))
    rng = np.random.default_rng(2)
    V = base_graph.num_vertices
    t.call("partition")
    t.call("update", rng.integers(0, V, 8), rng.integers(0, V, 8))
    assert t.port.stats()["delta"]["pending_batches"] == 1
    t.call("adapt", edge_updates=(rng.integers(0, V, 8),
                                  rng.integers(0, V, 8)))
    d = t.same_counters()
    assert d["fast_adapts"] == 1 and d["host_rebuilds"] == 0
    assert d["merged_batches"] == 2
    # reading the graph materializes the log: one rebuild, same arrays
    _same_graph(t.port.graph, t.ref.graph)
    t.same_counters()


def test_stage_interaction(base_graph):
    t = Twin(base_graph, dict(k=4, max_iters=47, seed=13))
    rng = np.random.default_rng(3)
    V = base_graph.num_vertices
    t.call("partition")
    t.call("adapt", edge_updates=(rng.integers(0, V, 8),
                                  rng.integers(0, V, 8)))
    t.call("stage", edge_updates=(rng.integers(0, V, 8),
                                  rng.integers(0, V, 8)))
    st = t.port.stats()
    assert st["staged"] == t.ref.stats()["staged"] == V
    assert st["uploads"] == 2                   # the staged snapshot's
    t.same_counters()
    t.call("adapt")                             # consumes the snapshot
    assert t.port.stats()["uploads"] == 2 and t.port.stats()["staged"] is None
    t.same_counters()


def test_pallas_interpret_once(base_graph):
    """The reference's Pallas fused backend (tiled slack slots, interpret
    mode) lands on the same labels as the port's kernel path."""
    cfg = dict(k=4, max_iters=41, seed=15)
    t = Twin(base_graph, cfg,
             ref_opts=RefOptions(engine="fused", score_backend="pallas",
                                 fused_update="on"))
    rng = np.random.default_rng(4)
    V = base_graph.num_vertices
    t.call("partition")
    for _ in range(2):
        t.call("adapt", edge_updates=(rng.integers(0, V, 24),
                                      rng.integers(0, V, 24)))
    d = t.same_counters()
    assert d["fast_adapts"] == 2 and d["host_rebuilds"] == 0


@pytest.mark.parametrize("backend,fused,record", [("cuda", "off", False),
                                                  ("cuda", "auto", None)])
def test_ineligible_modes_fall_back(base_graph, backend, fused, record):
    """The dense score kernel reads no delta segment and ``auto`` with
    history resolves to the chunked runner: both rebuild, as the
    reference's Pallas split path and auto+history do."""
    cfg = dict(k=4, max_iters=19, seed=17)
    t = Twin(base_graph, cfg,
             ref_opts=RefOptions(engine="fused" if record is False
                                 else "auto", score_backend="pallas",
                                 fused_update="off" if fused == "off"
                                 else "on"),
             opts=_opts(backend, fused,
                        engine="fused" if record is False else "auto"))
    t.call("partition", record_history=record)
    rng = np.random.default_rng(6)
    V = base_graph.num_vertices
    t.call("adapt", edge_updates=(rng.integers(0, V, 8),
                                  rng.integers(0, V, 8)),
           record_history=record)
    d = t.same_counters()
    assert d["fast_adapts"] == 0 and d["fallback_adapts"] == 1


# ---------------------------------------------------------------------------
# the compute path: frontier reconvergence
# ---------------------------------------------------------------------------

def _converged(g, cfg, opts=None, ref_opts=None):
    t = Twin(g, cfg, ref_opts=ref_opts, opts=opts)
    t.call("partition")
    r1, _ = t.call("adapt")
    r2, _ = t.call("adapt")
    assert np.array_equal(r1.labels, r2.labels), "not a fixed point"
    return t


FRONTIER = [("cuda", "auto", "on"), ("torch", "auto", "off"),
            ("torch", "on", "on")]


@pytest.mark.parametrize("backend,fused,ref_fused", FRONTIER)
def test_frontier_parity(fixed_point_graph, backend, fused, ref_fused):
    cfg = dict(k=4, max_iters=120, seed=9, c=1.6)
    t = _converged(fixed_point_graph, cfg,
                   opts=_opts(backend, fused, engine="fused"),
                   ref_opts=RefOptions(engine="fused",
                                       fused_update=ref_fused))
    rng = np.random.default_rng(3)
    V = fixed_point_graph.num_vertices
    b = (rng.integers(0, V, 8), rng.integers(0, V, 8))
    _, rf = t.call("adapt", edge_updates=b, frontier=True)
    d = t.same_counters()
    assert d["fast_adapts"] == 1 and d["host_rebuilds"] == 0
    assert t.port.stats()["uploads"] == 1
    assert rf.iterations >= 1 and len(rf.scored_per_iter) == rf.iterations
    assert rf.scored_vertices < 0.25 * V * rf.iterations
    # then a dense fast adapt on the merged segment
    t.call("adapt", edge_updates=(rng.integers(0, V, 8),
                                  rng.integers(0, V, 8)))
    assert t.same_counters()["fast_adapts"] == 2


def test_frontier_full_active_drains(fixed_point_graph):
    cfg = dict(k=4, max_iters=123, seed=9, c=1.6)
    t = _converged(fixed_point_graph, cfg)
    r2 = t.port.labels
    _, rf = t.call("adapt", frontier=True)
    np.testing.assert_array_equal(rf.labels, r2)
    assert rf.halted and rf.iterations == 1
    assert rf.scored_per_iter == (float(fixed_point_graph.num_vertices),)


def test_frontier_rejects_history_and_chunked(fixed_point_graph):
    cfg = dict(k=4, max_iters=124, seed=9, c=1.6)
    t = _converged(fixed_point_graph, cfg)
    for kw in (dict(record_history=True),
               dict(callback=lambda i, e: None)):
        msgs = []
        for s in (t.ref, t.port):
            with pytest.raises(ValueError, match="frontier") as info:
                s.adapt(frontier=True, **kw)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]
    s2 = open_session(graph_from_reference(fixed_point_graph),
                      SpinnerConfig(**cfg), _opts(engine="chunked"))
    s2.partition()
    with pytest.raises(ValueError, match="while_loop"):
        s2.adapt(frontier=True)


# ---------------------------------------------------------------------------
# resize, the one-shot API, lifecycle, carry-across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_new", [7, 3])
def test_resize_matches_reference(base_graph, k_new):
    t = Twin(base_graph, dict(k=5, max_iters=40, seed=21),
             ref_opts=RefOptions(), opts=_opts())
    t.call("partition", record_history=False)
    t.call("resize", k_new, record_history=False)
    assert t.port.cfg.k == t.ref.cfg.k == k_new
    # the module-level wrappers agree as well
    g = graph_from_reference(base_graph)
    prev = t.port.labels
    res, init = resize(g, prev, SpinnerConfig(k=k_new + 1, seed=2), k_new,
                       record_history=False, device="cpu")
    rres, rinit = ref_resize(base_graph, prev, RefConfig(k=k_new + 1, seed=2),
                             k_new, record_history=False)
    np.testing.assert_array_equal(init, rinit)
    _same(res, rres)


def test_resize_rejected_call_keeps_k(base_graph):
    s = open_session(graph_from_reference(base_graph),
                     SpinnerConfig(k=4, seed=1), _opts(engine="fused"))
    s.partition()
    with pytest.raises(ValueError):
        s.resize(6, record_history=True)
    assert s.cfg.k == 4


@pytest.mark.parametrize("engine", ["fused", "chunked", "host"])
def test_partition_is_a_throwaway_session(base_graph, engine):
    cfg = dict(k=4, max_iters=33, seed=23)
    record = False if engine == "fused" else None
    ref = ref_partition(base_graph, RefConfig(**cfg), engine=engine,
                        record_history=record)
    g = graph_from_reference(base_graph)
    one_shot = partition(g, SpinnerConfig(**cfg), engine=engine,
                         record_history=record, device="cpu")
    with open_session(g, SpinnerConfig(**cfg), _opts(engine=engine)) as s:
        live = s.partition(record_history=record)
        assert s.stats()["uploads"] == 0    # the one-shot call uploaded it
    for got in (one_shot, live):
        _same(got, ref)
        assert got.engine == engine and len(got.history) == len(ref.history)
    # incremental.adapt rides on the same path
    init_prev = one_shot.labels
    g2 = add_edges(g, [0, 5], [9, 11])
    got = adapt(g2, init_prev, SpinnerConfig(**cfg), engine="fused",
                record_history=False, device="cpu")
    want = ref_partition(ref_add_edges(base_graph, [0, 5], [9, 11]),
                         RefConfig(**cfg), init=ref_extend(init_prev, 600),
                         engine="fused", record_history=False)
    _same(got, want)


def test_closed_session_raises_one_message(base_graph):
    s = open_session(graph_from_reference(base_graph), SpinnerConfig(k=3),
                     _opts())
    s.partition(record_history=False)
    s.close()
    s.close()                                   # idempotent
    calls = [lambda: s.partition(), lambda: s.adapt(),
             lambda: s.resize(4), lambda: s.update([0], [1]),
             lambda: s.stage(edge_updates=([0], [1])), lambda: s.stats(),
             lambda: s.run_app("wcc")]
    for call in calls:
        with pytest.raises(RuntimeError) as info:
            call()
        assert str(info.value) == _CLOSED_MSG
    from repro.core.session import _CLOSED_MSG as REF_MSG
    assert _CLOSED_MSG == REF_MSG


def test_sharded_raises_and_run_app_delegates(base_graph):
    """A sharded session (the default one-rank mesh) runs as the
    reference's on a 1-device mesh, and so does its run_app, on the
    session's mesh with the workload's default plan; a single-device
    session's run_app delegates to the apps."""
    g = graph_from_reference(base_graph)
    cfg = dict(k=3, seed=2, max_iters=40)
    twin = Twin(base_graph, cfg, RefOptions(engine="sharded"),
                _opts(engine="sharded"))
    r, p = twin.call("partition")
    assert p.engine == r.engine == "sharded"
    for workload, kw in (("wcc", {}), ("pagerank", dict(plan="delta"))):
        got = twin.port.run_app(workload, **kw)
        want = twin.ref.run_app(workload, **kw)
        assert (got.plan, got.ndev, got.supersteps, got.converged,
                got.wire_bytes) == (want.plan, want.ndev, want.supersteps,
                                    want.converged, want.wire_bytes)
        if workload == "pagerank":
            np.testing.assert_allclose(got.values, want.values, rtol=1e-4,
                                       atol=1e-9)
        else:
            np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.device_messages,
                                      want.device_messages)
    s = open_session(g, SpinnerConfig(k=3, seed=2), _opts())
    with pytest.raises(ValueError, match="partition"):
        s.run_app("wcc")
    res = s.partition(record_history=False)
    from repro_torch.apps import run_app
    app = s.run_app("wcc")
    want = run_app(g, res.labels, "wcc", device="cpu")
    np.testing.assert_array_equal(app.values, want.values)
    assert app.supersteps == want.supersteps


def test_reference_labels_carried_across(fixed_point_graph):
    """A reference session's exported state seeds the port's session; the
    continuations agree, frontier fast path included."""
    cfg = dict(k=4, max_iters=60, seed=9, c=1.6)
    rs = ref_open(fixed_point_graph, RefConfig(**cfg),
                  RefOptions(engine="fused"))
    rs.partition()
    exported = rs.export_state()
    state = state_from_reference(exported, device="cpu")
    prev = state.labels.numpy()
    ps = open_session(graph_from_reference(fixed_point_graph),
                      SpinnerConfig(**cfg), _opts(engine="fused"))
    rng = np.random.default_rng(12)
    V = fixed_point_graph.num_vertices
    b = (rng.integers(0, V, 6), rng.integers(0, V, 6))
    _same(ps.adapt(prev=prev, edge_updates=b, frontier=True),
          rs.adapt(edge_updates=b, frontier=True))
    assert ps.stats()["delta"]["fast_adapts"] == 1
