"""repro_torch.cluster in one process, case for case with the reference's
``tests/test_cluster.py`` (its checkpoint-atomicity and train-supervisor
cases are in ``test_torch_durability.py``):

* snapshots: a same-capacity restore continues bit for bit, a restore
  onto fewer devices replays the elastic ``resize``; the snapshot files
  are the reference's (keys, file names, arrays);
* per-host edge shards: a host's row built from its file alone is row
  ``h`` of the full layout, byte for byte;
* ``PartitionSupervisor``: a kill recovers bit-identically (and equal to
  the reference's supervisor), after graph mutations too; a watermark
  mismatch refuses to resume; a torn snapshot falls back; the restart
  budget; the straggler watchdog;
* ``PartitionScheduler(deployment=)``: a failed dispatch is recovered and
  retried (its tickets equal the reference scheduler's), a tenant with no
  snapshot fails normally, a shrunk deployment recovers resized, a
  committed resize is rolled forward;
* the store: sliced waits beat between slices, an exhausted deadline is
  ``PeerLost``, deletes are best effort, values over the payload cap
  travel in chunks -- on a real ``TCPStore`` (port 0);
* leaving: a process that hosts the store leaves last in ``shutdown``
  (a peer still between wait slices passes its barrier), within
  ``rpc_timeout``; a peer only counts itself out; a lost store raises
  ``PeerLost`` at once;
* ``make_partition_mesh(devices=)``; the worker's K2 scores over its rows
  equal to the reference's host scatter, on halved weights too; the
  kernel build waiting for a concurrent one.
"""
import fcntl
import os
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.cluster import ClusterDeployment as RefDeployment
from repro.cluster import ClusterSupervisorConfig as RefSupConfig
from repro.cluster import PartitionSupervisor as RefSupervisor
from repro.cluster import save_snapshot as ref_save_snapshot
from repro.core import SpinnerConfig as RefConfig
from repro.core import generators as ref_generators
from repro.core.session import PartitionSession as RefSession
from repro.serve import PartitionScheduler as RefScheduler
from repro_torch.cluster import (ClusterConfig, ClusterDeployment,
                                 ClusterHandle, ClusterSupervisorConfig,
                                 PartitionSupervisor, PeerLost, WorkerLost,
                                 corrupt_newest_snapshot_at, kill_worker_at,
                                 load_local_shard, read_manifest,
                                 restore_session, save_snapshot,
                                 slow_worker_at, snapshot_steps,
                                 write_edge_shards)
from repro_torch.cluster.bootstrap import (CHUNK_BYTES, EXIT_KEY, bootstrap,
                                           serve_store)
from repro_torch.cluster.worker import owned_csr
from repro_torch.core import (EngineOptions, SpinnerConfig, generators,
                              metrics)
from repro_torch.core.distributed import shard_graph
from repro_torch.core.graph import Graph
from repro_torch.core.session import PartitionSession
from repro_torch.kernels import _build
from repro_torch.kernels.spinner_scores import spinner_scores
from repro_torch.launch.mesh import make_partition_mesh
from repro_torch.serve import PartitionScheduler

CFG = dict(k=6, seed=4, max_iters=40)
CPU = EngineOptions(device="cpu")
TORCH = EngineOptions(device="cpu", score_backend="torch")


@pytest.fixture(scope="module")
def small_world():
    """The reference's ``small_world`` fixture, built by the port."""
    return generators.watts_strogatz(3000, 10, 0.25, seed=7)


def _work(n_adapts=3):
    return [("partition", {})] + [("adapt", {})] * n_adapts


# ---------------------------------------------------------------------------
# Session state export/import + snapshot roundtrip
# ---------------------------------------------------------------------------

class TestSnapshotRoundtrip:
    def test_export_import_validation(self, small_world):
        cfg = SpinnerConfig(**CFG)
        with PartitionSession(small_world, cfg, CPU) as s:
            with pytest.raises(ValueError):
                s.export_state()           # nothing partitioned yet
            s.partition(record_history=False)
            state = s.export_state()
            assert state["k"] == cfg.k
            assert state["delta_watermark"] == s.delta_watermark
        with PartitionSession(small_world, SpinnerConfig(**{**CFG, "k": 5}),
                              CPU) as other:
            with pytest.raises(ValueError, match="k"):
                other.import_state(state)

    def test_same_capacity_restore_is_bit_exact(self, small_world, tmp_path):
        d = str(tmp_path / "snap")
        cfg = SpinnerConfig(**CFG)
        s = PartitionSession(small_world, cfg, CPU)
        s.partition(record_history=False)
        save_snapshot(d, s, 1)
        r1 = s.adapt(record_history=False)
        r2 = s.adapt(record_history=False)
        info = restore_session(d, small_world, options=CPU)
        assert info.saved_ndev == info.ndev == 1 and not info.resized
        assert info.step == 1 and info.k == cfg.k
        q1 = info.session.adapt(record_history=False)
        q2 = info.session.adapt(record_history=False)
        assert np.array_equal(r1.labels, q1.labels)
        assert np.array_equal(r2.labels, q2.labels)
        assert np.array_equal(r2.loads, q2.loads)
        s.close(), info.session.close()

    def test_snapshot_files_are_the_references(self, small_world, tmp_path):
        """The same run snapshotted by both packages: the same step
        directory, the same ``.npy`` files, equal arrays."""
        s = PartitionSession(small_world, SpinnerConfig(**CFG), CPU)
        s.partition(record_history=False)
        mine = save_snapshot(str(tmp_path / "port"), s, 3, ndev=2)
        rs = RefSession(_ref(small_world), RefConfig(**CFG))
        rs.partition(record_history=False)
        theirs = ref_save_snapshot(str(tmp_path / "ref"), rs, 3, ndev=2)
        assert os.path.basename(mine) == os.path.basename(theirs)
        npys = sorted(f for f in os.listdir(mine) if f.endswith(".npy"))
        assert npys == sorted(f for f in os.listdir(theirs)
                              if f.endswith(".npy"))
        for f in npys:
            a = np.load(os.path.join(mine, f))
            b = np.load(os.path.join(theirs, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        s.close(), rs.close()

    def test_restore_onto_fewer_devices_replays_resize(self, small_world,
                                                       tmp_path):
        """ndev 2 -> 1 restore halves k through the elastic resize and
        still reconverges to comparable quality (the 8 -> 4 path on real
        ranks is in test_torch_cluster_procs.py)."""
        d = str(tmp_path / "snap")
        cfg = SpinnerConfig(**{**CFG, "k": 8})
        s = PartitionSession(small_world, cfg, CPU)
        s.partition(record_history=False)
        save_snapshot(d, s, 1, ndev=2)
        info = restore_session(d, small_world, options=CPU, ndev=1)
        assert info.resized and info.k == 4 and info.saved_ndev == 2
        assert info.session.cfg.k == 4
        labels = info.session.labels
        assert labels.max() < 4
        assert metrics.rho(small_world, labels, 4) < cfg.c + 0.1
        base = PartitionSession(small_world,
                                SpinnerConfig(**{**CFG, "k": 4}), CPU)
        phi_base = metrics.phi(small_world,
                               base.partition(record_history=False).labels)
        assert metrics.phi(small_world, labels) >= 0.98 * phi_base
        s.close(), info.session.close(), base.close()

    def test_scale_k_off_keeps_k(self, small_world, tmp_path):
        d = str(tmp_path / "snap")
        s = PartitionSession(small_world, SpinnerConfig(**CFG), CPU)
        s.partition(record_history=False)
        save_snapshot(d, s, 1, ndev=2)
        info = restore_session(d, small_world, options=CPU, ndev=1,
                               scale_k=False)
        assert not info.resized and info.k == CFG["k"]
        s.close(), info.session.close()


def _ref(g):
    from repro.core import Graph as RefGraph
    return RefGraph(num_vertices=g.num_vertices, src=g.src, dst=g.dst,
                    weight=g.weight, row_ptr=g.row_ptr, deg_w=g.deg_w)


# ---------------------------------------------------------------------------
# Per-host edge shards: the local_only load path
# ---------------------------------------------------------------------------

class TestEdgeShards:
    @pytest.mark.parametrize("pad", [False, True])
    def test_local_rows_match_full_layout(self, tmp_path, pad):
        g = generators.watts_strogatz(512, 6, 0.3, seed=11)
        d = str(tmp_path / "shards")
        H = 4
        man = write_edge_shards(g, d, num_hosts=H)
        assert man["num_vertices"] == g.num_vertices
        assert read_manifest(d)["num_hosts"] == H
        full = shard_graph(g, H, pad=pad)
        for h in range(H):
            loc = load_local_shard(d, h, pad=pad)
            assert loc.local_only == h and loc.src_local.shape[0] == 1
            for field in ("src_local", "dst", "weight", "deg_w",
                          "edge_perm"):
                row = getattr(loc, field)[0]
                want = getattr(full, field)[h]
                if field == "edge_perm":      # indices into ONE file
                    row, want = row >= 0, want >= 0
                assert row.tobytes() == want.tobytes(), (h, field)
            assert loc.e_interior == full.e_interior
            assert loc.interior_counts[0] == full.interior_counts[h]
            assert loc.frontier_counts[0] == full.frontier_counts[h]

    def test_shard_files_cover_all_edges_once(self, tmp_path):
        g = generators.watts_strogatz(300, 4, 0.2, seed=2)
        d = str(tmp_path / "shards")
        write_edge_shards(g, d, num_hosts=3)
        total = sum(np.load(os.path.join(d, f"shard_{h}.npz"))["src"].size
                    for h in range(3))
        assert total == g.num_directed_entries

    def test_local_only_refuses_foreign_edges(self):
        g = generators.watts_strogatz(100, 4, 0.2, seed=2)
        with pytest.raises(ValueError, match="local_only=1"):
            shard_graph(g, 2, local_only=1)
        with pytest.raises(ValueError, match="outside"):
            shard_graph(g, 2, local_only=2)


# ---------------------------------------------------------------------------
# PartitionSupervisor: kill / corrupt / straggle, in process
# ---------------------------------------------------------------------------

class TestPartitionSupervisor:
    def _factory(self, graph):
        def factory(ndev):
            return graph, SpinnerConfig(**CFG), CPU
        return factory

    def test_kill_recovery_is_bit_identical(self, small_world, tmp_path):
        work = _work(3)
        clean = PartitionSupervisor(
            ClusterSupervisorConfig(snapshot_dir=str(tmp_path / "a")),
            self._factory(small_world))
        s1, r1 = clean.run(work)
        assert clean.restarts == 0 and clean.snapshots_restored == 0

        faulty = PartitionSupervisor(
            ClusterSupervisorConfig(snapshot_dir=str(tmp_path / "b")),
            self._factory(small_world))
        s2, r2 = faulty.run(work, faults=[kill_worker_at(2)])
        assert faulty.restarts == 1 and faulty.snapshots_restored == 1
        assert np.array_equal(s1.labels, s2.labels), \
            "same-capacity restart must replay bit-identically"
        assert np.array_equal(r1[-1].labels, r2[-1].labels)
        st = faulty.stats()
        assert st["restarts"] == 1 and len(st["recover_seconds"]) == 1
        assert st["straggler"]["flagged_steps"] == []
        assert snapshot_steps(str(tmp_path / "b"))[-1] == len(work)
        # ... and the reference's supervisor walks the same work the same
        ref = RefSupervisor(RefSupConfig(snapshot_dir=str(tmp_path / "r")),
                            lambda ndev: (_ref(small_world),
                                          RefConfig(**CFG), None))
        s3, r3 = ref.run(work, faults=[kill_worker_at(2)])
        for a, b in zip(r2, r3):
            np.testing.assert_array_equal(a.labels, b.labels)
            assert a.iterations == b.iterations
        s1.close(), s2.close(), s3.close()

    def test_kill_after_graph_mutations_replays_deltas(self, small_world,
                                                       tmp_path):
        rng = np.random.default_rng(17)
        V = small_world.num_vertices
        d1 = (rng.integers(0, V, 12), rng.integers(0, V, 12))
        d2 = (rng.integers(0, V, 9), rng.integers(0, V, 9))
        work = [
            ("partition", {}),
            ("update", {"edge_src": d1[0], "edge_dst": d1[1]}),
            ("adapt", {}),
            ("adapt", {"edge_updates": d2}),
            ("adapt", {}),
        ]
        clean = PartitionSupervisor(
            ClusterSupervisorConfig(snapshot_dir=str(tmp_path / "a")),
            self._factory(small_world))
        s1, r1 = clean.run(work)
        faulty = PartitionSupervisor(
            ClusterSupervisorConfig(snapshot_dir=str(tmp_path / "b")),
            self._factory(small_world))
        s2, r2 = faulty.run(work, faults=[kill_worker_at(4)])
        assert faulty.restarts == 1 and faulty.snapshots_restored == 1
        assert s2.delta_watermark == s1.delta_watermark == 2
        assert s2.graph.num_directed_entries == \
            s1.graph.num_directed_entries
        assert np.array_equal(s1.labels, s2.labels), \
            "restart after deltas must replay them bit-identically"
        assert np.array_equal(r1[-1].labels, r2[-1].labels)
        s1.close(), s2.close()

    def test_boot_raises_on_watermark_mismatch(self, small_world,
                                               tmp_path):
        rng = np.random.default_rng(3)
        V = small_world.num_vertices
        with_delta = [
            ("partition", {}),
            ("update", {"edge_src": rng.integers(0, V, 8),
                        "edge_dst": rng.integers(0, V, 8)}),
            ("adapt", {}),
        ]
        d = str(tmp_path / "s")
        sup = PartitionSupervisor(ClusterSupervisorConfig(snapshot_dir=d),
                                  self._factory(small_world))
        s, _ = sup.run(with_delta)
        s.close()
        stale = PartitionSupervisor(ClusterSupervisorConfig(snapshot_dir=d),
                                    self._factory(small_world))
        with pytest.raises(RuntimeError, match="delta"):
            stale.run(_work(3))

    def test_corrupt_snapshot_falls_back(self, small_world, tmp_path):
        work = _work(3)
        clean = PartitionSupervisor(
            ClusterSupervisorConfig(snapshot_dir=str(tmp_path / "a")),
            self._factory(small_world))
        s1, _ = clean.run(work)
        faulty = PartitionSupervisor(
            ClusterSupervisorConfig(snapshot_dir=str(tmp_path / "b")),
            self._factory(small_world))
        s2, _ = faulty.run(work, faults=[corrupt_newest_snapshot_at(2),
                                         kill_worker_at(2)])
        assert faulty.snapshots_corrupted == 1
        assert faulty.corrupt_skipped >= 1, \
            "restore must walk past the torn snapshot"
        assert np.array_equal(s1.labels, s2.labels)
        s1.close(), s2.close()

    def test_restart_budget_exhausted_raises(self, small_world, tmp_path):
        sup = PartitionSupervisor(
            ClusterSupervisorConfig(snapshot_dir=str(tmp_path / "s"),
                                    max_restarts=0),
            self._factory(small_world))
        with pytest.raises(WorkerLost):
            sup.run(_work(1), faults=[kill_worker_at(1)])

    def test_straggler_flagged_and_heartbeats(self, small_world, tmp_path):
        rng = np.random.default_rng(0)
        ups = [("update", {"edge_src": rng.integers(0, 100, 8),
                           "edge_dst": rng.integers(100, 200, 8)})
               for _ in range(4)]
        work = [("partition", {})] + ups
        sup = PartitionSupervisor(
            ClusterSupervisorConfig(snapshot_dir=str(tmp_path / "s"),
                                    straggler_warmup=3,
                                    heartbeat_deadline=1e9),
            self._factory(small_world))
        s, _ = sup.run(work, faults=[slow_worker_at(4, seconds=1.0)])
        st = sup.stats()
        assert [f[0] for f in st["straggler"]["flagged_steps"]] == [4]
        assert st["stale_workers"] == [] and 0 in st["heartbeat_ages"]
        s.close()


# ---------------------------------------------------------------------------
# Serving tier: deployment mode recovery
# ---------------------------------------------------------------------------

class _Boom(RuntimeError):
    pass


def _poison_once(session, kind="commit_adapt"):
    orig = getattr(session, kind)
    state = {"armed": True}

    def wrapper(*a, **kw):
        if state["armed"]:
            state["armed"] = False
            raise _Boom("injected dispatch failure")
        return orig(*a, **kw)

    setattr(session, kind, wrapper)


def _deploy_graph():
    return generators.watts_strogatz(1200, 8, 0.1, seed=3)


class TestSchedulerDeployment:
    # where a dispatch fails after its window's edges joined the delta
    # log: the torch backend's batchable tenants commit through
    # ``commit_adapt`` (as the reference's XLA ones); the CUDA backend's
    # dispatch serially through ``adapt``, whose run binds the merged delta
    @pytest.mark.parametrize("backend,poison", [("torch", "commit_adapt"),
                                                ("cuda", "_fast_bind")])
    def test_failed_dispatch_recovers_and_retries(self, tmp_path, backend,
                                                  poison):
        """A poisoned edge-update window is recovered from the snapshot and
        retried on the logical graph (its edges included); every ticket
        equals the reference scheduler's under the reference test's
        poison (``commit_adapt``)."""
        batch = tuple(np.random.default_rng(5).integers(0, 1200, (2, 30)))
        tickets = {}
        for side, sched_t, dep_t, cfg_t, g, opts, kind in (
                ("port", PartitionScheduler, ClusterDeployment, SpinnerConfig,
                 _deploy_graph(), (EngineOptions(
                     device="cpu", score_backend=backend),), poison),
                ("ref", RefScheduler, RefDeployment, RefConfig,
                 ref_generators.watts_strogatz(1200, 8, 0.1, seed=3), (),
                 "commit_adapt")):
            dep = dep_t(str(tmp_path / side))
            sched = sched_t(deployment=dep)
            sched.add_tenant("a", g, cfg_t(k=6, seed=1, max_iters=41), *opts)
            tk0 = sched.submit("a", "partition")
            assert sched.drain() == 1 and tk0.done and not tk0.failed
            assert dep.snapshots_written == 1
            _poison_once(sched.tenants["a"].session, kind)
            tk1 = sched.submit("a", "edge_updates", edge_updates=batch)
            assert sched.drain() == 1
            assert tk1.done and not tk1.failed, tk1.error
            st = sched.stats()
            assert st["recoveries"] == 1 and st["errors"] == 0
            assert st["deployment"]["recoveries"] == 1
            tk2 = sched.submit("a", "adapt")
            assert sched.drain() == 1 and not tk2.failed
            tickets[side] = (tk0, tk1, tk2)
        for a, b in zip(tickets["port"], tickets["ref"]):
            np.testing.assert_array_equal(a.result.labels, b.result.labels)
            np.testing.assert_array_equal(a.result.loads, b.result.loads)
            assert a.result.iterations == b.result.iterations

    def test_no_snapshot_fails_normally(self, tmp_path):
        dep = ClusterDeployment(str(tmp_path / "snaps"))
        sched = PartitionScheduler(deployment=dep)
        sched.add_tenant("a", _deploy_graph(),
                         SpinnerConfig(k=6, seed=1, max_iters=42), CPU)
        _poison_once(sched.tenants["a"].session, "partition")
        tk = sched.submit("a", "partition")
        assert sched.drain() == 1
        assert tk.failed and isinstance(tk.error, _Boom)
        assert dep.recovery_failures == 1
        assert sched.stats()["recoveries"] == 0

    def test_shrunk_deployment_recovers_resized(self, tmp_path):
        """Snapshot written at capacity 2; recovery at capacity 1 replays
        the elastic resize (k halves) before the retry."""

        class ShrinkingDeployment(ClusterDeployment):
            def __init__(self, root):
                super().__init__(root)
                self._ndev = 2

            @property
            def ndev(self):
                return self._ndev

        g = _deploy_graph()
        dep = ShrinkingDeployment(str(tmp_path / "snaps"))
        sched = PartitionScheduler(deployment=dep)
        sched.add_tenant("a", g, SpinnerConfig(k=8, seed=1, max_iters=43),
                         TORCH)
        sched.submit("a", "partition")
        assert sched.drain() == 1 and dep.snapshots_written == 1

        dep._ndev = 1                      # capacity shrank
        _poison_once(sched.tenants["a"].session)
        tk = sched.submit("a", "adapt")
        assert sched.drain() == 1 and not tk.failed, tk.error
        assert dep.resized_recoveries == 1
        sess = sched.tenants["a"].session
        assert sess.cfg.k == 4 and sess.labels.max() < 4
        assert metrics.rho(g, sess.labels, 4) < 1.2

    def test_recovery_rolls_forward_committed_resize(self, tmp_path):
        dep = ClusterDeployment(str(tmp_path / "snaps"), snapshot_every=2)
        sched = PartitionScheduler(deployment=dep)
        sched.add_tenant("a", _deploy_graph(),
                         SpinnerConfig(k=6, seed=1, max_iters=44), TORCH)
        sched.submit("a", "partition")
        assert sched.drain() == 1
        sched.submit("a", "adapt")
        assert sched.drain() == 1 and dep.snapshots_written == 1
        tkr = sched.submit("a", "resize", k=9)
        assert sched.drain() == 1 and not tkr.failed
        assert dep.snapshots_written == 1

        _poison_once(sched.tenants["a"].session)
        tk = sched.submit("a", "adapt")
        assert sched.drain() == 1 and not tk.failed, tk.error
        assert dep.k_roll_forwards == 1
        sess = sched.tenants["a"].session
        assert sess.cfg.k == 9, \
            "recovery must not revert a committed resize"
        assert sess.labels.max() < 9
        assert sched.stats()["deployment"]["k_roll_forwards"] == 1

    def test_deployment_pins_its_mesh(self, tmp_path):
        """``admit`` pins the deployment's mesh on tenants that bring none,
        and its width is the snapshots' ``ndev``."""
        mesh = make_partition_mesh(device="cpu", devices=[0])
        dep = ClusterDeployment(str(tmp_path / "snaps"), mesh=mesh)
        assert dep.ndev == 1
        opts = dep.admit("a", CPU)
        assert opts.mesh is mesh and opts.device == "cpu"
        assert dep.admit("b", EngineOptions(device="cpu", mesh=mesh)
                         ).mesh is mesh


# ---------------------------------------------------------------------------
# ClusterHandle on a real TCPStore: sliced waits, deadlines, deletes, chunks
# ---------------------------------------------------------------------------

def _handle(store, pid=0, world=2, rpc_timeout=5.0, poll_slice=0.05):
    return ClusterHandle(ClusterConfig(num_processes=world, process_id=pid,
                                       rpc_timeout=rpc_timeout,
                                       poll_slice=poll_slice), store)


class TestKvGetSlicing:
    def test_on_wait_fires_between_slices(self):
        store = serve_store()
        reader, writer = _handle(store), _handle(store, pid=1)
        beats = []

        def beat():
            beats.append(time.monotonic())
            if len(beats) == 2:               # the peer answers late
                writer.kv_put("x", "ok")

        reader.on_wait = beat
        assert reader.kv_get("x") == "ok"
        assert len(beats) == 2, \
            "the heartbeat hook must fire between wait slices"

    def test_exhausted_deadline_raises_peerlost(self):
        h = _handle(serve_store(), rpc_timeout=0.2)
        t0 = time.monotonic()
        with pytest.raises(PeerLost, match="timed out"):
            h.kv_get("gone")
        assert time.monotonic() - t0 < 5

    def test_kv_delete_is_best_effort(self):
        master = serve_store()
        h = _handle(dist.TCPStore("127.0.0.1", master.port, is_master=False,
                                  timeout=timedelta(seconds=2)))
        h.kv_put("g0/t1/lab/0", "a")
        h.kv_put("g0/t1/r1/0", "b")
        h.kv_put("g0/t2/lab/0", "c")
        h.kv_delete("g0/t1/")
        assert not master.check(["g0/t1/lab/0"])
        assert not master.check(["g0/t1/r1/0"])
        assert master.check(["g0/t2/lab/0"])
        del master                        # the store is gone
        h.kv_delete("g0/t2/")             # must not raise
        _handle(None).kv_delete("g0/")    # nor without any store

    def test_values_over_the_cap_travel_in_chunks(self):
        store = serve_store()
        h, peer = _handle(store), _handle(store, pid=1)
        big = np.arange(3 * CHUNK_BYTES // 4 + 5, dtype=np.int32)
        h.kv_put_array("g0/t0/lab/0", big)
        assert store.check([f"g0/t0/lab/0/c{i}" for i in range(3)])
        np.testing.assert_array_equal(
            peer.kv_get_array("g0/t0/lab/0", np.int32, big.shape), big)
        h.kv_delete("g0/t0/")
        assert not store.check(["g0/t0/lab/0/c0"])

    def test_allreduce_and_barrier_across_handles(self):
        store = serve_store()
        hs = [_handle(store, pid=p, world=3) for p in range(3)]
        out = [None] * 3

        def run(p):
            out[p] = hs[p].allreduce_sum("g0/t0/r1", np.float32([p, 0.5]))
            hs[p].barrier("g0/done")

        threads = [threading.Thread(target=run, args=(p,)) for p in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        for o in out:
            np.testing.assert_array_equal(o, np.float32([3, 1.5]))


def _client(master, timeout=60.0):
    return dist.TCPStore("127.0.0.1", master.port, is_master=False,
                         timeout=timedelta(seconds=timeout))


class TestLeaving:
    """A process that hosts the store leaves last: the port's counterpart
    of the reference's coordinator outliving its clients' barrier."""

    def test_host_outlives_a_peer_between_wait_slices(self):
        master = serve_store()
        host = _handle(_client(master), pid=0, rpc_timeout=10.0)
        peer = _handle(_client(master), pid=1, rpc_timeout=10.0)
        host.hosts_store, peer.hosts_store = True, False
        between = threading.Event()

        def between_slices():
            between.set()
            time.sleep(10 * peer.cfg.poll_slice)

        peer.on_wait = between_slices
        errors = []

        def run(h, after=None):
            try:
                if after is not None:   # the host passes the barrier while
                    assert after.wait(10)   # the peer is between slices
                h.barrier("done")
                h.shutdown()
            except Exception as e:      # read back on the main thread
                errors.append((h.process_id, e))

        threads = [threading.Thread(target=run, args=(peer,)),
                   threading.Thread(target=run, args=(host, between))]
        for t in threads:
            t.start()
        threads[1].join(30)
        assert not threads[1].is_alive()
        del master                      # the host process exits
        threads[0].join(30)
        assert not threads[0].is_alive()
        assert errors == []

    def test_lost_store_raises_at_once(self):
        master = serve_store()
        h = _handle(_client(master), rpc_timeout=60.0, poll_slice=5.0)
        del master
        t0 = time.monotonic()
        with pytest.raises(PeerLost, match="lost"):
            h.kv_get("x")
        assert time.monotonic() - t0 < 2
        with pytest.raises(PeerLost, match="barrier"):
            h.barrier("done")

    def test_host_waits_at_most_rpc_timeout(self):
        master = serve_store()
        host = _handle(_client(master), rpc_timeout=0.5)
        host.hosts_store = True
        t0 = time.monotonic()
        host.shutdown()                 # the peer never counts itself out
        assert 0.5 <= time.monotonic() - t0 < 5
        assert host.store is None
        assert master.add(f"{EXIT_KEY}/count", 0) == 1

    @pytest.mark.parametrize("host_alive", [True, False])
    def test_a_peer_only_counts_itself_out(self, host_alive):
        master = serve_store()
        peer = _handle(_client(master), pid=1, rpc_timeout=60.0)
        if not host_alive:
            del master
        t0 = time.monotonic()
        peer.shutdown()
        assert time.monotonic() - t0 < 2
        assert peer.store is None
        if host_alive:
            assert master.add(f"{EXIT_KEY}/count", 0) == 1
            assert not master.check([f"{EXIT_KEY}/done"])

    def test_the_serving_process_is_the_host(self):
        master = serve_store()
        cfg = ClusterConfig(port=master.port, num_processes=2)
        assert bootstrap(cfg).hosts_store
        assert not bootstrap(cfg, hosts_store=False).hosts_store
        assert not bootstrap(ClusterConfig(port=master.port + 1),
                             ).hosts_store
        port = master.port
        del master                      # the registry does not keep it
        assert not ClusterHandle(ClusterConfig(
            port=port, num_processes=2)).hosts_store


# ---------------------------------------------------------------------------
# explicit device list for make_partition_mesh
# ---------------------------------------------------------------------------

def test_local_and_one_process_global_mesh():
    h = ClusterHandle(ClusterConfig(device="cpu"))
    assert h.local_mesh().size() == 1
    assert h.global_mesh().size() == dist.get_world_size() == 1


def test_make_partition_mesh_explicit_devices():
    m = make_partition_mesh(device="cpu", devices=[0])
    assert m.size() == 1 and list(m.get_coordinate()) == [0]
    with pytest.raises(ValueError):
        make_partition_mesh(num_devices=2, device="cpu", devices=[0])
    with pytest.raises(ValueError, match="ranks"):
        make_partition_mesh(device="cpu", devices=[dist.get_world_size()])


# ---------------------------------------------------------------------------
# the worker's K2 over its rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("halve", [False, True])
@pytest.mark.parametrize("world,pid", [(1, 0), (2, 1), (3, 0)])
def test_worker_scores_equal_host_scatter(tmp_path, halve, world, pid):
    """K2 over the CSR of a worker's rows (hosts ``h % world == pid``),
    the full label vector its lookup, equals the reference worker's
    ``np.add.at`` over the same entries bit for bit -- on halved weights
    too (sums of halves are exact in float32, as integer sums are)."""
    g = generators.watts_strogatz(500, 6, 0.3, seed=2)
    if halve:
        g = Graph(num_vertices=g.num_vertices, src=g.src, dst=g.dst,
                  weight=g.weight * np.float32(0.5), row_ptr=g.row_ptr,
                  deg_w=g.deg_w * np.float32(0.5))
    d = str(tmp_path / "shards")
    man = write_edge_shards(g, d, num_hosts=4)
    owned = [h for h in range(4) if h % world == pid]
    V, k = g.num_vertices, 7
    rows, row_ptr, src, dst, w = owned_csr(d, owned, man["v_per_host"], V)
    labels = np.random.default_rng(world).integers(0, k, V).astype(np.int32)
    got = spinner_scores(torch.from_numpy(labels[rows]),
                         torch.from_numpy(row_ptr), torch.from_numpy(dst),
                         torch.from_numpy(w), k,
                         lookup=torch.from_numpy(labels))
    want = np.zeros((V, k), np.float32)
    np.add.at(want, (src, labels[dst]), w)
    assert got.numpy().tobytes() == want[rows].tobytes()
    assert np.isin(src, rows).all()


def test_kernel_build_waits_for_a_concurrent_build(monkeypatch, tmp_path):
    """Two processes building at once: the second waits on the build
    lock, then finds the libraries built."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    done = threading.Event()
    with open(tmp_path / ".lock", "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)
        t = threading.Thread(target=lambda: (_build.build(()), done.set()))
        t.start()
        time.sleep(0.3)
        assert not done.is_set(), "build must wait for the held lock"
    t.join(10)
    assert done.is_set()
