"""The serving tier with sharded tenants at world sizes 2 and 4, on the CPU.

The reference's ``SCHED_SHARDED_EXCHANGE_NDEV`` case
(``tests/test_serve.py``): two sharded tenants on the allgather and delta
exchange plans beside a single-device tenant, each sent an edge-update
batch and a plain ``adapt`` that coalesce into one window.  The
reference runs it over ``W`` forced host devices in a subprocess; the
port runs it SPMD, one process per rank in a gloo group, every rank
driving the same scheduler (``torch_spawn.run_world``).  Every rank's
ticket results must equal the reference's and the port's own twin
sessions (update, then adapt), bit for bit: labels, loads, iterations,
halted.  The port's tenants use the torch scatter backend, the
counterpart of the reference's XLA backend.
"""
import numpy as np
import pytest
import torch

from torch_spawn import run_world

WORLDS = (2, 4)
TIMEOUT = 300
NAMES = ("sh_allgather", "sh_delta", "fused")
CFG = dict(k=8, max_iters=162, seed=4)


def fleet(generators, rng):
    """(name, graph, plan or None, batch) of the fleet, drawn in the
    reference's order."""
    def delta(v, n=16):
        s = rng.integers(0, v, n)
        d = rng.integers(0, v, n)
        m = s != d
        return s[m], d[m]

    out = []
    for i, plan in enumerate(("allgather", "delta")):
        g = generators.watts_strogatz(2000, 8, 0.15, seed=i)
        out.append((f"sh_{plan}", g, plan, delta(g.num_vertices)))
    g = generators.watts_strogatz(900, 8, 0.15, seed=9)
    out.append(("fused", g, None, delta(g.num_vertices)))
    return out


REFERENCE = """
import sys
import numpy as np
from repro.core import EngineOptions, SpinnerConfig, generators
from repro.launch.mesh import make_partition_mesh
from repro.serve import PartitionScheduler
sys.path.insert(0, "tests")
from test_torch_serve_mesh import CFG, fleet

ndev, out = int(sys.argv[1]), sys.argv[2]
mesh = make_partition_mesh(ndev)
cfg = SpinnerConfig(**CFG)
sched = PartitionScheduler(max_batch=8)
tks, res = {}, {}
for name, g, plan, d in fleet(generators, np.random.default_rng(1)):
    opts = (EngineOptions(engine="sharded", mesh=mesh, label_exchange=plan)
            if plan else None)
    sched.add_tenant(name, g, cfg, opts, partition=True)
    sched.submit(name, "edge_updates", edge_updates=d)
    tks[name] = sched.submit(name, "adapt")     # coalesces into the eu
sched.drain()
st = sched.stats()
assert st["errors"] == 0, st
assert st["serial_dispatches"] >= 2, st
for name, tk in tks.items():
    r = tk.result
    res[name + "_labels"] = np.asarray(r.labels)
    res[name + "_loads"] = np.asarray(r.loads)
    res[name + "_meta"] = np.array([r.iterations, r.halted, tk.coalesced])
np.savez(out, **res)
"""


def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the port: the same fleet through the scheduler, then
    each tenant's twin session."""
    import torch.distributed as dist

    from repro_torch.core import (EngineOptions, SpinnerConfig, generators,
                                  open_session)
    from repro_torch.launch.mesh import make_partition_mesh
    from repro_torch.serve import PartitionScheduler

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_partition_mesh(device="cpu")
        cfg = SpinnerConfig(**CFG)
        sched = PartitionScheduler(max_batch=8)
        tks, opts_of, res = {}, {}, {}
        members = fleet(generators, np.random.default_rng(1))
        for name, g, plan, d in members:
            opts_of[name] = (
                EngineOptions(device="cpu", engine="sharded", mesh=mesh,
                              label_exchange=plan, score_backend="torch")
                if plan else EngineOptions(device="cpu",
                                           score_backend="torch"))
            sched.add_tenant(name, g, cfg, opts_of[name], partition=True)
            sched.submit(name, "edge_updates", edge_updates=d)
            tks[name] = sched.submit(name, "adapt")
        sched.drain()
        st = sched.stats()
        res["stats"] = np.array([st["errors"], st["serial_dispatches"],
                                 st["batched_dispatches"],
                                 st["coalescing_factor"]])
        for name, g, plan, d in members:
            r = tks[name].result
            res[name + "_labels"] = r.labels
            res[name + "_loads"] = r.loads
            res[name + "_meta"] = np.array([r.iterations, r.halted,
                                            tks[name].coalesced])
            twin = open_session(g, cfg, opts_of[name])
            twin.partition(record_history=False)
            twin.update(*d)
            t = twin.adapt(record_history=False)
            res[name + "_twin_labels"] = t.labels
            res[name + "_twin_loads"] = t.loads
            res[name + "_twin_meta"] = np.array([t.iterations, t.halted, 2])
        np.savez(out % rank, **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world in WORLDS:
        data, port = run_world(tmp_path_factory.mktemp(f"serve{world}"),
                               world, _worker, REFERENCE, [], TIMEOUT)
        out[world] = (dict(np.load(data)),
                      [dict(np.load(port % r)) for r in range(world)])
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_fleet_matches_reference_and_twins(runs, world, name):
    ref, ranks = runs[world]
    for got in ranks:
        errors, serial, batched, coalescing = got["stats"]
        assert errors == 0 and serial == 3 and batched == 0
        assert coalescing == 1.0
        for f in ("labels", "loads", "meta"):
            np.testing.assert_array_equal(got[f"{name}_{f}"],
                                          ref[f"{name}_{f}"], f)
            np.testing.assert_array_equal(got[f"{name}_{f}"],
                                          got[f"{name}_twin_{f}"], f)
