"""The port's serving tier against the reference's, on the CPU.

Mirrors ``tests/test_serve.py`` case for case, at its sizes: the batched
same-bucket runner (``engine.run_batched``) against each element's own
``run_bound`` and against the reference's batched runner on its XLA
backend, the session's batch hooks, delta coalescing, the scheduler
(windows, groups, dispatch order, policies, failures, retirement) and the
synthetic traffic.  Port tenants on the torch scatter backend batch, as
the reference's XLA tenants do; CUDA-backend tenants (the kernels' plain
versions on CPU tensors) dispatch serially.  Every comparison is bitwise:
labels, loads, iterations and halted (score(G) is compared bitwise only
between the port's own runs: the reference sums it in another order).
The reference's compile counters have no counterpart; the port's
scheduler counts O(E) uploads instead, and a warm fleet does none.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import SpinnerConfig as RefConfig
from repro.core import engine as ref_engine
from repro.core import generators as ref_generators
from repro.core import open_session as ref_open
from repro.core.spinner import prepare_init as ref_prepare_init
from repro.serve import PartitionScheduler as RefScheduler
from repro.serve import traffic as ref_traffic
from repro_torch.convert import graph_from_reference
from repro_torch.core import (EngineOptions, SpinnerConfig, add_edges, delta,
                              engine, open_session, prepare_init)
from repro_torch.core.session import _CLOSED_MSG
from repro_torch.launch.mesh import make_partition_mesh
from repro_torch.serve import (KSweepPrecompile, PartitionScheduler,
                               StagePrefetch, default_batch_min, traffic)

TORCH = EngineOptions(device="cpu", score_backend="torch")
CUDA = EngineOptions(device="cpu", score_backend="cuda")


def _ref_graph(v, seed):
    return ref_generators.watts_strogatz(v, 8, 0.1, seed=seed)


def _graph(v, seed):
    return graph_from_reference(_ref_graph(v, seed))


def _delta_batch(rng, v, n=12):
    src = rng.integers(0, v, n)
    dst = rng.integers(0, v, n)
    m = src != dst
    return src[m], dst[m]


def _assert_same(a, b, what=""):
    np.testing.assert_array_equal(a.labels, np.asarray(b.labels), what)
    np.testing.assert_array_equal(a.loads, np.asarray(b.loads), what)
    assert a.iterations == b.iterations, what
    assert a.halted == b.halted, what


def _session(g, cfg, opts=TORCH):
    s = open_session(g, cfg, opts)
    s.partition(record_history=False)
    return s


def _ref_session(g, cfg: dict):
    s = ref_open(g, RefConfig(**cfg))
    s.partition(record_history=False)
    return s


def _parts_for(graph, cfg):
    """A padded (init_state, bind) work item, as run_fused builds one."""
    labels, loads, key = prepare_init(graph, cfg, None, device="cpu")
    bind, padded = engine.make_bind(graph, cfg, TORCH, "cpu")
    state = engine.init_state(
        engine.pad_labels(labels, padded.num_vertices), loads, key)
    return state, bind


def _same_state(a, b):
    for f in engine.SpinnerState._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "key":
            assert x == y
        else:
            assert torch.equal(x, y), f


# ---------------------------------------------------------------------------
# engine.run_batched: the batched same-bucket runner
# ---------------------------------------------------------------------------

class TestBatchedRunner:
    def test_batched_matches_unbatched_per_element(self):
        """3 same-bucket graphs with their own seeds: every element's final
        state (its host key included) is bit-identical to its own
        ``run_bound``, and its labels, loads, iterations and halted to the
        reference's batched run on its XLA backend."""
        cfg = dict(k=8, max_iters=141, seed=3)
        rgraphs = [_ref_graph(490 + 5 * i, seed=i) for i in range(3)]
        graphs = [graph_from_reference(g) for g in rgraphs]
        assert len({engine.graph_buckets(g) for g in graphs}) == 1
        items, refs = [], []
        for i, g in enumerate(graphs):
            c = SpinnerConfig(**dict(cfg, seed=10 + i))
            state, bind = _parts_for(g, c)
            items.append((state, bind))
            refs.append(engine.run_bound(c, TORCH, state, bind))
        c0 = SpinnerConfig(**cfg)
        assert len({engine.batch_signature(c0, TORCH, b)
                    for _, b in items}) == 1
        outs = engine.run_batched(items, c0, TORCH)
        assert len({int(o.iteration) for o in outs}) > 1   # one froze first
        for out, ref in zip(outs, refs):
            _same_state(out, ref)
        # the reference's batched runner from the same starts
        ref_items, ref_cfg = [], RefConfig(**cfg)
        for i, g in enumerate(rgraphs):
            labels, loads, key = ref_prepare_init(
                g, RefConfig(**dict(cfg, seed=10 + i)), None)
            opts_t = ref_engine._autotuned(g, ref_cfg,
                                           ref_engine._DEFAULT_OPTS)
            bind, padded = ref_engine._single_bind(g, ref_cfg, opts_t)
            ref_items.append((ref_engine.init_state(
                ref_engine.pad_labels(labels, padded.num_vertices), loads,
                key), bind))
        ref_outs = ref_engine.run_batched(ref_items, ref_cfg, opts_t)
        for out, r in zip(outs, ref_outs):
            np.testing.assert_array_equal(out.labels.numpy(),
                                          np.asarray(r.labels))
            np.testing.assert_array_equal(out.loads.numpy(),
                                          np.asarray(r.loads))
            assert int(out.iteration) == int(r.iteration)
            assert bool(out.halted) == bool(r.halted)

    def test_batch_of_one_bit_identical(self):
        cfg = SpinnerConfig(k=6, max_iters=142, seed=1)
        g = _graph(430, seed=4)
        state, bind = _parts_for(g, cfg)
        ref = engine.run_bound(cfg, TORCH, state, bind)
        (out,) = engine.run_batched([(state, bind)], cfg, TORCH)
        _same_state(out, ref)

    def test_batch_bucket(self):
        assert [engine.batch_bucket(n) for n in (1, 2, 3, 4, 5, 8, 9)] \
            == [1, 2, 4, 4, 8, 8, 16]

    def test_deltas_of_different_lengths_share_a_batch(self):
        """Warm tenants in one bucket carry delta segments of different
        lengths -- in the last round one has none, its slack having
        overflowed into a rebuild that stays in the bucket: one
        signature, one batched run, each equal to its twin's serial adapt
        and to the reference's batched run of the same sessions, counters
        included."""
        cfg = dict(k=8, max_iters=141, seed=3)
        rgraphs = [_ref_graph(490 + 5 * i, seed=i) for i in range(3)]
        ports = [_session(graph_from_reference(g), SpinnerConfig(**cfg))
                 for g in rgraphs]
        twins = [_session(graph_from_reference(g), SpinnerConfig(**cfg))
                 for g in rgraphs]
        refs = [_ref_session(g, cfg) for g in rgraphs]
        rng = np.random.default_rng(0)
        for rnd in range(3):
            ds = [_delta_batch(rng, g.num_vertices, 12 * (i + 1) + rnd)
                  for i, g in enumerate(rgraphs)]
            work = [s.adapt_parts(edge_updates=d)
                    for s, d in zip(ports, ds)]
            lengths = [w[1].score[3].shape[0] if len(w[1].score) > 3 else 0
                       for w in work]
            assert len(set(lengths)) == 3, lengths
            assert len({engine.batch_signature(c, o, b)
                        for _, b, c, o in work}) == 1
            outs = engine.run_batched([(st, b) for st, b, _, _ in work],
                                      work[0][2], work[0][3])
            r_work = [r.adapt_parts(edge_updates=d)
                      for r, d in zip(refs, ds)]
            r_outs = ref_engine.run_batched(
                [(st, b) for st, b, _, _ in r_work], r_work[0][2],
                r_work[0][3])
            for s, t, r, d, out, r_out in zip(ports, twins, refs, ds, outs,
                                              r_outs):
                got = s.commit_adapt(out)
                _assert_same(got, t.adapt(edge_updates=d,
                                          record_history=False))
                _assert_same(got, r.commit_adapt(r_out))
                for key in ("fast_adapts", "fallback_adapts",
                            "host_rebuilds"):
                    assert s.stats()["delta"][key] \
                        == r.stats()["delta"][key] \
                        == t.stats()["delta"][key]
        assert 0 in lengths
        assert ports[2].stats()["delta"]["fallback_adapts"] == 1

    def test_refuses_other_backends_and_mixed_signatures(self):
        cfg = SpinnerConfig(k=4, max_iters=60, seed=0)
        a, b = _parts_for(_graph(300, 1), cfg), _parts_for(_graph(900, 2),
                                                           cfg)
        with pytest.raises(ValueError, match="one batch_signature"):
            engine.run_batched([a, b], cfg, TORCH)
        with pytest.raises(ValueError, match="'torch' scatter backend"):
            engine.run_batched([a], cfg, CUDA)
        assert engine.run_batched([], cfg, TORCH) == []


# ---------------------------------------------------------------------------
# session scheduler entry points
# ---------------------------------------------------------------------------

class TestAdaptParts:
    def test_stream_matches_adapt(self, rng):
        """adapt_parts -> run_batched -> commit_adapt walks the same stream
        as adapt(): fast-path deltas, then an argless re-run; equal to the
        reference's session too."""
        cfg = dict(k=8, max_iters=143, seed=5)
        rg = _ref_graph(400, seed=0)
        g = graph_from_reference(rg)
        stream = [_delta_batch(rng, 400), _delta_batch(rng, 400), None]
        twin = _session(g, SpinnerConfig(**cfg))
        s = _session(g, SpinnerConfig(**cfg))
        ref = _ref_session(rg, cfg)
        for d in stream:
            kw = {} if d is None else {"edge_updates": d}
            r_twin = twin.adapt(record_history=False, **kw)
            r_ref = ref.adapt(record_history=False, **kw)
            state, bind, c, opts = s.adapt_parts(edge_updates=d)
            (out,) = engine.run_batched([(state, bind)], c, opts)
            got = s.commit_adapt(out)
            _assert_same(got, r_twin, f"delta {d is None}")
            _assert_same(got, r_ref, f"delta {d is None}")
        assert s.stats()["delta"]["fast_adapts"] == 2
        for key in ("fast_adapts", "fallback_adapts", "host_rebuilds",
                    "watermark"):
            assert s.stats()["delta"][key] == ref.stats()["delta"][key]
        np.testing.assert_array_equal(s.labels, ref.labels)

    def test_fallback_and_staged_snapshot(self, rng):
        """A batch that overflows the slack rebuilds (fallback_adapts and
        host_rebuilds counted, as adapt does); an argless adapt_parts
        consumes a staged snapshot."""
        cfg = SpinnerConfig(k=8, max_iters=143, seed=5)
        g = _graph(400, seed=0)
        big = _delta_batch(rng, 400, 3000)
        s, twin = _session(g, cfg), _session(g, cfg)
        st, b, c, o = s.adapt_parts(edge_updates=big)
        (out,) = engine.run_batched([(st, b)], c, o)
        _assert_same(s.commit_adapt(out),
                     twin.adapt(edge_updates=big, record_history=False))
        for sess in (s, twin):
            d = sess.stats()["delta"]
            assert (d["fallback_adapts"], d["host_rebuilds"]) == (1, 1)
        g2 = add_edges(s.graph, *_delta_batch(rng, 400, 30))
        s.stage(g2)
        twin.stage(g2)
        st, b, c, o = s.adapt_parts()
        assert s.stats()["staged"] is None
        (out,) = engine.run_batched([(st, b)], c, o)
        _assert_same(s.commit_adapt(out), twin.adapt(record_history=False))

    def test_batchable_eligibility(self):
        cfg = SpinnerConfig(k=4, max_iters=144, seed=0)
        g = _graph(300, seed=1)
        assert open_session(g, cfg, TORCH).batchable()
        mesh = make_partition_mesh(device="cpu")
        for opts in (EngineOptions(device="cpu", score_backend="torch",
                                   engine="chunked"),
                     EngineOptions(device="cpu", score_backend="torch",
                                   engine="host"),
                     EngineOptions(device="cpu", score_backend="torch",
                                   engine="sharded", mesh=mesh),
                     CUDA):
            s = open_session(g, cfg, opts)
            assert not s.batchable(), opts
            assert s.adapt_parts() is None, opts

    def test_batch_key_same_bucket(self):
        cfg = SpinnerConfig(k=4, max_iters=144, seed=0)
        assert open_session(_graph(300, seed=1), cfg, TORCH).batch_key() \
            == open_session(_graph(310, seed=2), cfg, TORCH).batch_key()
        assert open_session(_graph(300, seed=1), cfg, TORCH).batch_key() \
            != open_session(_graph(900, seed=2), cfg, TORCH).batch_key()
        s = _session(_graph(300, seed=1), cfg)
        st, b, c, o = s.adapt_parts()
        assert engine.batch_signature(c, o, b) == s.batch_key()


# ---------------------------------------------------------------------------
# delta coalescing
# ---------------------------------------------------------------------------

class TestCoalescing:
    @pytest.mark.parametrize("batches", [
        [([0, 1], [2, 3]), ([0, 4], [2, 5])],
        [([2], [0]), ([2], [0])], [([2], [0]), ([0], [2])],
        [([0], [2]), ([2], [0])], [([0], [2]), ([0], [2])],
        [([0, 2], [2, 0])], [([3], [3])], []])
    def test_coalesce_updates_matches_reference(self, batches):
        from repro.core import delta as ref_delta
        bs = [(np.array(s), np.array(d)) for s, d in batches]
        for dedupe in (True, False):
            got = delta.coalesce_updates(bs, dedupe=dedupe)
            want = ref_delta.coalesce_updates(bs, dedupe=dedupe)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)

    def test_coalesced_equals_one_by_one(self, rng):
        """One coalesced batch == N sequential ones, down to the labels,
        and both equal the rebuild oracle."""
        cfg = SpinnerConfig(k=8, max_iters=145, seed=2)
        g = _graph(420, seed=3)
        b1, b2 = _delta_batch(rng, 420), _delta_batch(rng, 420)
        b3 = (np.concatenate([b1[0][:3], _delta_batch(rng, 420, 6)[0]]),
              np.concatenate([b1[1][:3], _delta_batch(rng, 420, 6)[1]]))
        one_by_one = _session(g, cfg)
        one_by_one.update(*b1).update(*b2)
        r_seq = one_by_one.adapt(edge_updates=b3, record_history=False)
        assert one_by_one.stats()["delta"]["fast_adapts"] == 1
        coalesced = _session(g, cfg)
        r_coal = coalesced.adapt(
            edge_updates=delta.coalesce_updates([b1, b2, b3]),
            record_history=False)
        _assert_same(r_seq, r_coal, "coalesced vs one-by-one")
        g2 = add_edges(add_edges(add_edges(g, *b1), *b2), *b3)
        _assert_same(_session(g, cfg).adapt(new_graph=g2,
                                            record_history=False),
                     r_coal, "coalesced vs rebuild oracle")


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

class TestScheduler:
    def test_window_coalescing_matches_serial(self, rng):
        """A queued [eu, eu, adapt] window dispatches once; all three
        tickets resolve to update;update;adapt replayed on a twin and to
        the reference scheduler's result."""
        cfg = dict(k=8, max_iters=146, seed=4)
        rg = _ref_graph(410, seed=5)
        g = graph_from_reference(rg)
        b1, b2 = _delta_batch(rng, 410), _delta_batch(rng, 410)
        sched, rsched = PartitionScheduler(), RefScheduler()
        sched.add_tenant("a", g, SpinnerConfig(**cfg), TORCH, partition=True)
        rsched.add_tenant("a", rg, RefConfig(**cfg), partition=True)
        tks = []
        for sc in (sched, rsched):
            tks.append((sc.submit("a", "edge_updates", edge_updates=b1),
                        sc.submit("a", "edge_updates", edge_updates=b2),
                        sc.submit("a", "adapt")))
            assert sc.drain() == 3
        t1, t2, t3 = tks[0]
        assert t1.result is t2.result is t3.result
        assert t3.coalesced == 3 and t3.done and not t3.failed
        assert sched.stats()["coalescing_factor"] == 2.0
        twin = _session(g, SpinnerConfig(**cfg))
        twin.update(*b1).update(*b2)
        _assert_same(t3.result, twin.adapt(record_history=False))
        _assert_same(t3.result, tks[1][2].result)

    def test_mixed_fleet_parity_engines_and_plans(self, rng):
        """Batched torch-backend tenants, a CUDA-backend tenant, sharded
        tenants on both exchange plans (a one-rank gloo mesh) and a
        chunked tenant in one fleet: every ticket equals the twin
        session's call and the reference fleet's ticket."""
        cfg = dict(k=4, max_iters=147, seed=6)
        mesh = make_partition_mesh(device="cpu")
        from repro.core import EngineOptions as RefOptions
        from repro.launch.mesh import make_partition_mesh as ref_mesh
        rmesh = ref_mesh(1)
        fleet = {
            "f1": (_ref_graph(400, 1), TORCH, None),
            "f2": (_ref_graph(405, 2), TORCH, None),    # same bucket as f1
            "cu": (_ref_graph(410, 7), CUDA, None),     # serial, K1 path
            "sh_ag": (_ref_graph(600, 3),
                      EngineOptions(device="cpu", engine="sharded",
                                    mesh=mesh, label_exchange="allgather"),
                      RefOptions(engine="sharded", mesh=rmesh,
                                 label_exchange="allgather")),
            "sh_dl": (_ref_graph(600, 4),
                      EngineOptions(device="cpu", engine="sharded",
                                    mesh=mesh, label_exchange="delta"),
                      RefOptions(engine="sharded", mesh=rmesh,
                                 label_exchange="delta")),
            "ch": (_ref_graph(500, 5),
                   EngineOptions(device="cpu", engine="chunked"),
                   RefOptions(engine="chunked")),
        }
        deltas = {n: _delta_batch(rng, g.num_vertices)
                  for n, (g, _, _) in fleet.items()}
        sched = PartitionScheduler(max_batch=8, batch_min=2)
        rsched = RefScheduler(max_batch=8, batch_min=2)
        tks, rtks = {}, {}
        for n, (rg, opts, ropts) in fleet.items():
            sched.add_tenant(n, graph_from_reference(rg),
                             SpinnerConfig(**cfg), opts, partition=True)
            rsched.add_tenant(n, rg, RefConfig(**cfg), ropts,
                              partition=True)
            tks[n] = sched.submit(n, "edge_updates", edge_updates=deltas[n])
            rtks[n] = rsched.submit(n, "edge_updates",
                                    edge_updates=deltas[n])
        assert sched.drain() == rsched.drain() == len(fleet)
        st = sched.stats()
        assert st["errors"] == 0, st
        assert st["batched_dispatches"] == 1      # f1 + f2
        assert st["serial_dispatches"] == 4       # cu, sharded x2, chunked
        assert st["batch_occupancy"] == 1.0
        for n, (rg, opts, _) in fleet.items():
            twin = open_session(graph_from_reference(rg),
                                SpinnerConfig(**cfg), opts)
            twin.partition(record_history=False)
            _assert_same(tks[n].result, twin.adapt(edge_updates=deltas[n],
                                                   record_history=False), n)
            _assert_same(tks[n].result, rtks[n].result, n)

    def test_batch_min_one_forces_batched_path(self, rng):
        cfg = SpinnerConfig(k=6, max_iters=148, seed=7)
        g = _graph(440, seed=6)
        d = _delta_batch(rng, 440)
        sched = PartitionScheduler(batch_min=1)
        sched.add_tenant("a", g, cfg, TORCH, partition=True)
        tk = sched.submit("a", "edge_updates", edge_updates=d)
        assert sched.drain() == 1
        assert sched.stats()["batched_dispatches"] == 1
        assert sched.stats()["batch_occupancy"] == 1.0
        _assert_same(tk.result, _session(g, cfg).adapt(
            edge_updates=d, record_history=False))

    def test_lone_window_runs_serially_below_batch_min(self, rng):
        """Below ``batch_min`` a batchable window runs its own work item
        through ``run_bound``: same result, counted as serial."""
        cfg = SpinnerConfig(k=6, max_iters=148, seed=7)
        g = _graph(440, seed=6)
        d = _delta_batch(rng, 440)
        sched = PartitionScheduler(batch_min=2)
        sched.add_tenant("a", g, cfg, TORCH, partition=True)
        tk = sched.submit("a", "edge_updates", edge_updates=d)
        sched.drain()
        st = sched.stats()
        assert (st["batched_dispatches"], st["serial_dispatches"]) == (0, 1)
        _assert_same(tk.result, _session(g, cfg).adapt(
            edge_updates=d, record_history=False))

    def test_priority_and_staleness_order(self):
        clock = {"t": 0.0}
        cfg = SpinnerConfig(k=4, max_iters=149, seed=8)
        sched = PartitionScheduler(max_batch=1, policies=(),
                                   clock=lambda: clock["t"])
        sched.add_tenant("lo", _graph(300, seed=1), cfg, TORCH,
                         priority=1.0, partition=True)
        sched.add_tenant("hi", _graph(300, seed=2), cfg, TORCH,
                         priority=5.0, partition=True)
        t_lo = sched.submit("lo", "adapt")
        clock["t"] = 1.0
        t_hi = sched.submit("hi", "adapt")
        clock["t"] = 2.0
        sched.step()   # urgency: hi 5*1 > lo 1*2
        assert t_hi.done and not t_lo.done
        sched.step()
        assert t_lo.done

    def test_preempt_staleness_overrides_priority(self):
        clock = {"t": 0.0}
        cfg = SpinnerConfig(k=4, max_iters=149, seed=9)
        sched = PartitionScheduler(max_batch=1, policies=(),
                                   preempt_staleness=10.0,
                                   clock=lambda: clock["t"])
        sched.add_tenant("lo", _graph(300, seed=3), cfg, TORCH,
                         priority=1.0, partition=True)
        sched.add_tenant("hi", _graph(300, seed=4), cfg, TORCH,
                         priority=100.0, partition=True)
        t_lo = sched.submit("lo", "adapt")
        clock["t"] = 11.0
        t_hi = sched.submit("hi", "adapt")
        sched.step()   # lo is past the SLO: jumps the priority queue
        assert t_lo.done and not t_hi.done

    def test_resize_and_errors(self, rng):
        cfg = SpinnerConfig(k=4, max_iters=151, seed=1)
        g = _graph(350, seed=7)
        sched = PartitionScheduler(policies=())
        sched.add_tenant("a", g, cfg, TORCH, partition=True)
        tk = sched.submit("a", "resize", k=6)
        bad = sched.submit("a", "edge_updates",
                           edge_updates=(np.array([999999]),
                                         np.array([0])))
        sched.drain()
        twin = _session(g, cfg)
        _assert_same(tk.result, twin.resize(6, record_history=False))
        assert bad.failed and isinstance(bad.error, ValueError)
        ok = sched.submit("a", "adapt")      # errors don't wedge the queue
        sched.drain()
        assert ok.done and not ok.failed
        _assert_same(ok.result, twin.adapt(record_history=False))
        with pytest.raises(ValueError, match="unknown request kind"):
            sched.submit("a", "bogus")

    def test_remove_tenant_fails_queued_and_is_final(self):
        cfg = SpinnerConfig(k=4, max_iters=152, seed=2)
        sched = PartitionScheduler()
        t = sched.add_tenant("a", _graph(300, seed=8), cfg, TORCH,
                             partition=True)
        uploads = sched.uploads
        tk = sched.submit("a", "adapt")
        sched.remove_tenant("a")
        assert tk.failed and "retired" in str(tk.error)
        assert sched.uploads == uploads == 1   # kept across retirement
        t.session.close()          # double close via scheduler + here: ok
        with pytest.raises(KeyError):
            sched.remove_tenant("a")
        with pytest.raises(KeyError):
            sched.submit("a", "adapt")

    def test_no_card_raises_unless_cpu(self, monkeypatch, tmp_path):
        """No fallback that hides the device: without a card a tenant that
        did not ask for the CPU is refused, under a deployment too."""
        from repro_torch.cluster import ClusterDeployment
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        sched = PartitionScheduler()
        cfg = SpinnerConfig(k=4, max_iters=60, seed=0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sched.add_tenant("a", _graph(300, seed=1), cfg)
        sched.add_tenant("b", _graph(300, seed=1), cfg, TORCH)
        deployed = PartitionScheduler(
            deployment=ClusterDeployment(str(tmp_path)))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            deployed.add_tenant("a", _graph(300, seed=1), cfg)
        deployed.add_tenant("b", _graph(300, seed=1), cfg, TORCH)
        assert default_batch_min() in (2, 10 ** 9)


# ---------------------------------------------------------------------------
# prefetch policies
# ---------------------------------------------------------------------------

class TestPolicies:
    def test_ksweep_precompile_scans_resize(self, rng):
        cfg = SpinnerConfig(k=4, max_iters=153, seed=3)
        pol = KSweepPrecompile()
        sched = PartitionScheduler(max_batch=1, policies=(pol,))
        sched.add_tenant("a", _graph(380, seed=9), cfg, TORCH,
                         partition=True)
        sched.add_tenant("b", _graph(380, seed=10), cfg, TORCH,
                         partition=True)
        sched.submit("a", "edge_updates",
                     edge_updates=_delta_batch(rng, 380))
        tk = sched.submit("b", "resize", k=7)
        sched.step()    # dispatches a; scans b's k=7 off-path
        assert ("b", 7) in pol.warmed
        assert pol.stats() == {"warmed": 1, "compiled": 0}
        sched.drain()
        twin = _session(_graph(380, seed=10), cfg)
        _assert_same(tk.result, twin.resize(7, record_history=False))

    def test_stage_prefetch_stages_next_rebind(self, rng):
        cfg = SpinnerConfig(k=4, max_iters=154, seed=4)
        g = _graph(360, seed=11)
        g2 = add_edges(g, *_delta_batch(rng, 360, 30))
        pol = StagePrefetch()
        sched = PartitionScheduler(max_batch=1, policies=(pol,))
        sched.add_tenant("a", _graph(360, seed=12), cfg, TORCH,
                         partition=True)
        sched.add_tenant("b", g, cfg, TORCH, partition=True)
        sched.submit("a", "adapt")
        tk = sched.submit("b", "adapt", new_graph=g2)
        sched.step()    # dispatches a; stages b's snapshot off-path
        assert pol.staged == 1
        assert sched.tenants["b"].session.stats()["staged"] is not None
        sched.drain()
        _assert_same(tk.result, _session(g, cfg).adapt(
            new_graph=g2, record_history=False))

    def test_policy_error_is_recorded_not_raised(self, rng):
        class Broken:
            name = "broken"

            def run(self, sched):
                raise RuntimeError("boom")

        cfg = SpinnerConfig(k=4, max_iters=154, seed=4)
        sched = PartitionScheduler(policies=(Broken(),))
        sched.add_tenant("a", _graph(360, seed=12), cfg, TORCH,
                         partition=True)
        tk = sched.submit("a", "adapt")
        sched.drain()
        assert tk.done and not tk.failed
        assert sched.stats()["policy_errors"] == [
            "broken: RuntimeError('boom')"]


# ---------------------------------------------------------------------------
# a warm fleet uploads nothing (the port's counterpart of zero compiles)
# ---------------------------------------------------------------------------

class TestUploads:
    @pytest.mark.parametrize("opts", [TORCH, CUDA], ids=["torch", "cuda"])
    def test_second_fleet_zero_uploads_since_mark(self, rng, opts):
        """Admission uploads each tenant's graph once; after the mark,
        rounds of edge updates (batched for the torch backend, serial for
        the CUDA backend) upload nothing, and a fresh fleet in the same
        bucket does the same."""
        cfg = SpinnerConfig(k=6, max_iters=157, seed=6)

        def fleet(sched, seeds):
            for i, s in enumerate(seeds):
                sched.add_tenant(f"t{i}", _graph(420 + i, seed=s), cfg, opts,
                                 partition=True)
            sched.mark()
            for _ in range(2):
                for i in range(len(seeds)):
                    sched.submit(f"t{i}", "edge_updates",
                                 edge_updates=_delta_batch(rng, 420))
                sched.drain()
            for t in sched.tenants.values():      # the warm path throughout
                assert t.session.stats()["delta"]["fallback_adapts"] == 0
            return sched.stats()

        for seeds in ([20, 21], [22, 23]):
            st = fleet(PartitionScheduler(batch_min=2), seeds)
            assert st["errors"] == 0
            assert st["uploads"] == 2 and st["uploads_since_mark"] == 0
            batched = opts is TORCH
            assert st["batched_dispatches"] == (2 if batched else 0)
            assert st["serial_dispatches"] == (0 if batched else 4)


# ---------------------------------------------------------------------------
# closed-session lifecycle
# ---------------------------------------------------------------------------

class TestClosedSession:
    def test_close_idempotent_and_uniform_message(self):
        cfg = SpinnerConfig(k=4, max_iters=158, seed=7)
        s = _session(_graph(320, seed=15), cfg)
        s.close()
        s.close()                                  # double close: no-op
        entry_points = [
            lambda: s.partition(),
            lambda: s.adapt(),
            lambda: s.resize(8),
            lambda: s.update(np.array([0]), np.array([1])),
            lambda: s.stage(edge_updates=(np.array([0]), np.array([1]))),
            lambda: s.stats(),
            lambda: s.batchable(),
            lambda: s.batch_key(),
            lambda: s.adapt_parts(),
            lambda: s.commit_adapt(None),
            lambda: s.export_state(),
            lambda: s.import_state({}),
        ]
        for fn in entry_points:
            with pytest.raises(RuntimeError) as ei:
                fn()
            assert str(ei.value) == _CLOSED_MSG
        with open_session(_graph(320, seed=15), cfg, TORCH) as ctx:
            ctx.partition(record_history=False)
        ctx.close()                                # after __exit__: no-op


# ---------------------------------------------------------------------------
# synthetic traffic
# ---------------------------------------------------------------------------

class TestTraffic:
    @pytest.mark.parametrize("args", [
        dict(n=50, v_min=256, v_max=4096, seed=3),
        dict(n=16, v_min=16_384, v_max=1_048_576, alpha=2.2, seed=0)])
    def test_powerlaw_sizes_match_reference(self, args):
        a = traffic.powerlaw_sizes(**args)
        assert a == ref_traffic.powerlaw_sizes(**args)
        assert a == traffic.powerlaw_sizes(**args)
        assert all(args["v_min"] <= v <= args["v_max"] for v in a)

    @pytest.mark.parametrize("args", [
        dict(duration=5.0, rate=3.0, k_choices=(4, 8), seed=1),
        dict(duration=20.0, rate=0.25, burst_mean=3, mix=(0.8, 0.15, 0.05),
             edges_per_update=1_000, k_choices=(16, 32, 64), seed=0)])
    def test_poisson_trace_matches_reference(self, args):
        tenants = {"a": 300, "b": 400, "c": 20_000}
        ev = traffic.poisson_trace(tenants, **args)
        want = ref_traffic.poisson_trace(tenants, **args)
        assert len(ev) == len(want) > 0
        assert ev == sorted(ev, key=lambda e: (e.t, e.tenant))
        for e, w in zip(ev, want):
            assert (e.t, e.tenant, e.kind) == (w.t, w.tenant, w.kind)
            assert e.payload.keys() == w.payload.keys()
            if e.kind == "edge_updates":
                for x, y in zip(e.payload["edge_updates"],
                                w.payload["edge_updates"]):
                    np.testing.assert_array_equal(x, y)
                    assert int(x.max()) < tenants[e.tenant]
            else:
                assert e.payload == w.payload

    def test_tenant_graph_and_random_edge_updates_match_reference(self):
        g = traffic.tenant_graph(700, seed=3, k_nbrs=16)
        rg = ref_traffic.tenant_graph(700, seed=3, k_nbrs=16)
        for f in ("src", "dst", "weight", "row_ptr", "deg_w"):
            np.testing.assert_array_equal(getattr(g, f),
                                          np.asarray(getattr(rg, f)))
        for x, y in zip(
                traffic.random_edge_updates(700, 50,
                                            np.random.default_rng(2)),
                ref_traffic.random_edge_updates(700, 50,
                                                np.random.default_rng(2))):
            np.testing.assert_array_equal(x, y)

    def test_open_loop_replay_smoke(self):
        cfg = SpinnerConfig(k=4, max_iters=159, seed=8)
        names = {"a": 300, "b": 310}
        sched = PartitionScheduler(batch_min=2)
        for n, v in names.items():
            sched.add_tenant(n, _graph(v, seed=ord(n[0])), cfg, TORCH,
                             partition=True)
        ev = traffic.poisson_trace(names, duration=0.3, rate=20.0,
                                   burst_mean=3.0, mix=(0.9, 0.1, 0.0),
                                   seed=2)
        done = traffic.replay(sched, ev)
        st = sched.stats()
        assert done == len(ev) == st["completed"]
        assert st["errors"] == 0 and st["queued"] == 0
        assert st["coalescing_factor"] >= 1.0
        assert st["latency"]["p50"] >= 0.0


def test_replace_keeps_dataclass_config():
    """The batch signature ignores ``seed`` and ``c`` (they reach a run
    through its key and capacity only), as the reference's does."""
    cfg = SpinnerConfig(k=4, max_iters=60, seed=0)
    other = dataclasses.replace(cfg, seed=9, c=1.3)
    assert engine._static_cfg(cfg) == engine._static_cfg(other)
    assert engine._static_cfg(cfg) != engine._static_cfg(
        dataclasses.replace(cfg, k=5))
