"""repro_torch.cluster across real processes, on the CPU, against the
reference's ``repro.cluster``:

* a 2-process cluster (workers spawned by ``ProcessClusterSupervisor``,
  the store hosted by the supervisor) loses worker 1 at iteration 8; the
  1-process generation that resumes from the snapshot ends bit-identical
  to an uninterrupted 1-process run, and to the reference's
  ``ProcessClusterSupervisor`` 1-process run on the same shards;
* a 2-process cluster on three hosts' shards written by the reference
  (worker 0 owns hosts 0 and 2) halts on the iteration the reference's
  worker halts on, with its labels;
* edge shards written by either package are read by the other;
* the reference's 8 -> 4 shrink on 8 gloo ranks (``torch_spawn``): every
  rank runs the supervisor; after ``kill_worker_at(2, surviving_ndev=4)``
  the factory builds ``make_partition_mesh(devices=[0, 1, 2, 3])`` (ranks
  4-7 join the subgroup's creation, then leave) and the restored session
  reconverges through ``resize`` within the reference's 2% of the
  uninterrupted baseline's phi.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.cluster import ProcessClusterConfig as RefProcConfig
from repro.cluster import ProcessClusterSupervisor as RefProcSupervisor
from repro.cluster import load_local_shard as ref_load_local_shard
from repro.cluster import write_edge_shards as ref_write_edge_shards
from repro.core import generators as ref_generators
from repro.core.distributed import shard_graph as ref_shard_graph
from repro_torch.cluster import (ProcessClusterConfig,
                                 ProcessClusterSupervisor, load_local_shard,
                                 write_edge_shards)
from repro_torch.core import generators, metrics
from repro_torch.core.distributed import shard_graph
from torch_spawn import run_ranks

# bounds a hung worker: its heartbeat goes stale after the grace period
PROC = dict(poll_interval=0.2, spawn_grace=60.0, heartbeat_deadline=30.0)
SHRINK_TIMEOUT = 300


def _run(wd, world, job, ref=False):
    if ref:
        return RefProcSupervisor(RefProcConfig(
            workdir=wd, num_processes=world, poll_interval=0.2), job).run()
    return ProcessClusterSupervisor(ProcessClusterConfig(
        workdir=wd, num_processes=world, **PROC), job).run()


def test_two_process_cluster_worker_kill(tmp_path):
    """Hard-kill worker 1 mid-run: the supervisor respawns a 1-process
    generation that resumes from the snapshot and ends bit-identical to
    an uninterrupted 1-process run and to the reference's."""
    g = generators.watts_strogatz(600, 8, 0.2, seed=5)
    shards = str(tmp_path / "shards")
    write_edge_shards(g, shards, num_hosts=2)
    base_job = {"shard_dir": shards, "k": 4, "seed": 1, "max_iters": 24,
                "snapshot_every": 4, "c": 1.05, "rpc_timeout": 60}
    job = {**base_job, "device": "cpu"}

    wd = str(tmp_path / "faulty")
    out = _run(wd, 2, {**job, "fault": {"gen": 0, "pid": 1, "iteration": 8}})
    assert out["restarts"] == 1, out
    assert out["result"]["gen"] == 1 and out["result"]["world"] == 1, out
    gens = out["generations"]
    assert gens[0]["dead"] == [1] and gens[1]["dead"] == []
    labels = np.load(os.path.join(wd, "labels.npy"))
    with open(os.path.join(wd, "stats_g1_p0.json")) as f:
        st = json.load(f)
    assert st["supersteps"] == 24 - 8, "gen 1 resumes at the snapshot"
    assert st["device"] == "cpu" and st["k2_launches"] == 0   # plain K2

    ref_out = _run(str(tmp_path / "ref"), 1, job)
    assert ref_out["restarts"] == 0
    labels_ref = np.load(str(tmp_path / "ref" / "labels.npy"))
    assert np.array_equal(labels, labels_ref), \
        "recovered run must be bit-identical to the uninterrupted reference"
    assert out["result"]["phi"] == pytest.approx(ref_out["result"]["phi"])
    assert out["result"]["phi"] > 0.3, out["result"]
    assert metrics.phi_weighted(g, labels) == pytest.approx(
        out["result"]["phi"], abs=1e-6)

    jax_out = _run(str(tmp_path / "jax"), 1, base_job, ref=True)
    jax_labels = np.load(str(tmp_path / "jax" / "labels.npy"))
    assert np.array_equal(labels, jax_labels), \
        "the port's workers must walk the reference worker's trajectory"
    assert jax_out["result"]["iterations"] == out["result"]["iterations"]
    assert jax_out["result"]["phi"] == out["result"]["phi"]


def test_halting_cluster_equals_reference_worker(tmp_path):
    """Three hosts' shards written by the reference, a 2-process port
    cluster (worker 0 owns hosts 0 and 2: rows in two ranges) run to the
    Section 3.3 halt: the reference worker's iterations and labels."""
    g = ref_generators.watts_strogatz(900, 8, 0.3, seed=2)
    shards = str(tmp_path / "shards")
    ref_write_edge_shards(g, shards, num_hosts=3)
    job = {"shard_dir": shards, "k": 5, "seed": 3, "max_iters": 200,
           "snapshot_every": 50, "rpc_timeout": 60}
    port = _run(str(tmp_path / "port"), 2, {**job, "device": "cpu"})
    ref = _run(str(tmp_path / "ref"), 1, job, ref=True)
    assert port["result"]["halted"] and ref["result"]["halted"]
    assert port["result"]["iterations"] == ref["result"]["iterations"]
    assert port["result"]["iterations"] < job["max_iters"]
    np.testing.assert_array_equal(
        np.load(str(tmp_path / "port" / "labels.npy")),
        np.load(str(tmp_path / "ref" / "labels.npy")))


def test_shards_cross_packages(tmp_path):
    """Shards written by either package are read by the other: each
    host's row from its file alone is row h of the reader's full layout."""
    g = generators.watts_strogatz(400, 6, 0.3, seed=8)
    rg = ref_generators.watts_strogatz(400, 6, 0.3, seed=8)
    H = 3
    write_edge_shards(g, str(tmp_path / "port"), num_hosts=H)
    ref_write_edge_shards(rg, str(tmp_path / "ref"), num_hosts=H)
    with open(tmp_path / "port" / "manifest.json") as f, \
            open(tmp_path / "ref" / "manifest.json") as r:
        assert json.load(f) == json.load(r)
    for pad in (False, True):
        mine, theirs = shard_graph(g, H, pad=pad), ref_shard_graph(
            rg, H, pad=pad)
        for h in range(H):
            by_port = load_local_shard(str(tmp_path / "ref"), h, pad=pad)
            by_ref = ref_load_local_shard(str(tmp_path / "port"), h,
                                          pad=pad)
            for field in ("src_local", "dst", "weight", "deg_w"):
                assert getattr(by_port, field)[0].tobytes() == \
                    getattr(mine, field)[h].tobytes(), (h, field)
                np.testing.assert_array_equal(
                    np.asarray(getattr(by_ref, field)[0]),
                    np.asarray(getattr(theirs, field)[h]))
            assert by_port.e_interior == by_ref.e_interior


def _global_mesh_rank(rank: int, world: int, store: str, out: str) -> None:
    """One process of a store-bootstrapped cluster: rank 0 hosts the store
    and publishes its port in a file; both build the global mesh."""
    import torch.distributed as dist

    from repro_torch.cluster import ClusterConfig, bootstrap
    from repro_torch.cluster.bootstrap import serve_store
    from repro_torch.launch.mesh import mesh_group, mesh_rank, mesh_size

    port_file = os.path.join(os.path.dirname(store), "port")
    if rank == 0:
        master = serve_store()
        with open(port_file + ".tmp", "w") as f:
            f.write(str(master.port))
        os.replace(port_file + ".tmp", port_file)
    deadline = time.monotonic() + 60
    while not os.path.exists(port_file) and time.monotonic() < deadline:
        time.sleep(0.05)
    with open(port_file) as f:
        port = int(f.read())
    h = bootstrap(ClusterConfig(port=port, num_processes=world,
                                process_id=rank, device="cpu"))
    mesh = h.global_mesh()
    x = torch.tensor([rank + 1.0])
    dist.all_reduce(x, group=mesh_group(mesh))
    with open(out % rank + ".json", "w") as f:
        json.dump({"size": mesh_size(mesh), "rank": mesh_rank(mesh),
                   "sum": float(x)}, f)
    h.barrier("done")
    h.shutdown()


def test_global_mesh_spans_the_cluster(tmp_path):
    """``ClusterHandle.global_mesh`` builds a process group over the
    handle's store: a 2-process mesh whose all-reduce sums both ranks."""
    pattern = run_ranks(tmp_path, 2, _global_mesh_rank, 120)
    for r in range(2):
        with open(pattern % r + ".json") as f:
            assert json.load(f) == {"size": 2, "rank": r, "sum": 3.0}


class _Retired(Exception):
    """A rank outside the shrunk mesh leaves the supervised run."""


def _shrink_rank(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.cluster import (ClusterSupervisorConfig,
                                     PartitionSupervisor, kill_worker_at)
    from repro_torch.core import (EngineOptions, SpinnerConfig, generators,
                                  metrics, open_session)
    from repro_torch.launch.mesh import make_partition_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        g = generators.watts_strogatz(3000, 10, 0.25, seed=7)
        cfg = dict(seed=3, max_iters=60)
        meshes = {}

        def factory(ndev):
            nd = ndev or world
            # collective over the whole world: every rank builds it
            mesh = meshes[nd] = make_partition_mesh(
                device="cpu", devices=list(range(nd)))
            if rank >= nd:
                raise _Retired()
            return g, SpinnerConfig(k=8, **cfg), EngineOptions(
                device="cpu", mesh=mesh)

        snap = os.path.join(os.path.dirname(store), f"snap{rank}")
        sup = PartitionSupervisor(ClusterSupervisorConfig(snapshot_dir=snap),
                                  factory)
        work = [("partition", {})] + [("adapt", {})] * 3
        try:
            session, _ = sup.run(work, ndev=world, faults=[
                kill_worker_at(2, surviving_ndev=4)])
        except _Retired:
            return
        st = sup.stats()
        base = open_session(g, SpinnerConfig(k=4, **cfg), EngineOptions(
            device="cpu", mesh=meshes[4]))
        phi_base = metrics.phi(g, base.partition(record_history=False).labels)
        with open(out % rank + ".json", "w") as f:
            json.dump({"labels_max": int(session.labels.max()),
                       "phi": metrics.phi(g, session.labels),
                       "phi_base": phi_base,
                       "rho": metrics.rho(g, session.labels, 4),
                       "restarts": st["restarts"],
                       "resized": st["resized_on_restore"],
                       "ndev": st["ndev"], "k": st["k"],
                       "engine": session.stats()["engine"]}, f)
    finally:
        dist.destroy_process_group()


def test_supervisor_shrink_8_to_4_devices(tmp_path):
    pattern = run_ranks(tmp_path, 8, _shrink_rank, SHRINK_TIMEOUT)
    runs = []
    for r in range(4):
        with open(pattern % r + ".json") as f:
            runs.append(json.load(f))
    assert all(run == runs[0] for run in runs), runs
    st = runs[0]
    assert st["restarts"] == 1 and st["resized"], st
    assert st["ndev"] == 4 and st["k"] == 4 and st["labels_max"] < 4, st
    assert st["phi"] >= 0.98 * st["phi_base"], st
    assert st["rho"] < 1.2, st
    for r in range(4, 8):
        assert not os.path.exists(pattern % r + ".json")
