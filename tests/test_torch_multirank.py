"""The sharded engine at world sizes 2 and 4 on the CPU, against the reference.

The port runs SPMD, one process per shard in a gloo group, and the
reference runs ``partition(engine="sharded")`` over ``ndev`` forced host
devices in a subprocess, as ``tests/test_distributed.py`` does
(``torch_spawn.run_world``).  Both start together, once per world size,
and run every case; the tests then compare labels, loads,
iterations, halted and ``exchanged_bytes`` bit for bit, for all four
exchange plans with and without overlap, replicated and folded noise, on
the ``"cuda"`` backend (its plain versions on CPU tensors) and the torch
oracle.  Every rank must return the same result.
"""
import json

import numpy as np
import pytest
import torch

from torch_spawn import run_world

WORLDS = (2, 4)
GRAPH = dict(n=600, k=8, p=0.2, seed=11)
CFG = dict(k=6, seed=2, max_iters=60)
CASES = [(plan, overlap, "replicated")
         for plan in ("allgather", "halo", "halo_delta", "delta")
         for overlap in ("on", "off")] + [
    ("allgather", "off", "folded"), ("halo_delta", "on", "folded"),
    ("delta", "off", "folded")]
BACKENDS = ("cuda", "torch")
TIMEOUT = 240

REFERENCE = """
import json, sys
import numpy as np
from repro.core import EngineOptions, SpinnerConfig, generators, partition
from repro.core.distributed import comm_stats, shard_layout
from repro.core import engine
from repro.launch.mesh import make_partition_mesh
ndev, out, cases, graph, cfg = (int(sys.argv[1]), sys.argv[2],
                                json.loads(sys.argv[3]),
                                json.loads(sys.argv[4]),
                                json.loads(sys.argv[5]))
g = generators.watts_strogatz(graph["n"], graph["k"], graph["p"],
                              seed=graph["seed"])
mesh = make_partition_mesh(ndev)
res, stats = {}, {}
for i, (plan, overlap, noise) in enumerate(cases):
    opts = EngineOptions(label_exchange=plan, overlap=overlap,
                         sharded_noise=noise)
    r = partition(g, SpinnerConfig(**cfg), record_history=False,
                  engine="sharded", mesh=mesh, options=opts)
    res[f"{i}_labels"] = r.labels
    res[f"{i}_loads"] = r.loads
    res[f"{i}_meta"] = np.array([r.iterations, r.halted, r.exchanged_bytes])
    padded, _ = engine.padded_view(g, opts)
    sg = shard_layout(padded, ndev, pad=True)
    stats[i] = comm_stats(sg, SpinnerConfig(**cfg), opts)
np.savez(out, src=g.src, dst=g.dst, weight=g.weight, row_ptr=g.row_ptr,
         deg_w=g.deg_w, num_vertices=g.num_vertices, **res)
with open(out + ".json", "w") as f:
    json.dump(stats, f)
"""


def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One shard of the port: every case on both backends."""
    import torch.distributed as dist

    from repro_torch.core import (EngineOptions, SpinnerConfig, generators,
                                  partition)
    from repro_torch.core.distributed import (comm_stats,
                                              run_sharded_hostloop,
                                              shard_layout)
    from repro_torch.core.engine import padded_view
    from repro_torch.launch.mesh import make_partition_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        g = generators.watts_strogatz(GRAPH["n"], GRAPH["k"], GRAPH["p"],
                                      seed=GRAPH["seed"])
        mesh = make_partition_mesh(device="cpu")
        cfg = SpinnerConfig(**CFG)
        res, stats = {}, {}
        for i, (plan, overlap, noise) in enumerate(CASES):
            for backend in BACKENDS:
                opts = EngineOptions(device="cpu", label_exchange=plan,
                                     overlap=overlap, sharded_noise=noise,
                                     score_backend=backend)
                r = partition(g, cfg, record_history=False,
                              engine="sharded", mesh=mesh, options=opts)
                res[f"{i}_{backend}_labels"] = r.labels
                res[f"{i}_{backend}_loads"] = r.loads
                res[f"{i}_{backend}_meta"] = np.array(
                    [r.iterations, r.halted, r.exchanged_bytes])
            padded, _ = padded_view(g, opts)
            stats[i] = comm_stats(shard_layout(padded, world, pad=True), cfg,
                                  opts)
        state = run_sharded_hostloop(g, cfg, mesh,
                                     options=EngineOptions(device="cpu"))
        res["hostloop_labels"] = state.labels[:g.num_vertices].numpy()
        res["hostloop_iterations"] = np.array(int(state.iteration))
        res.update(src=g.src, dst=g.dst, weight=g.weight)
        np.savez(out % rank, **res)
        with open(out % rank + ".json", "w") as f:
            json.dump(stats, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per world size: the reference's results and each rank's."""
    out = {}
    for world in WORLDS:
        data, port = run_world(
            tmp_path_factory.mktemp(f"world{world}"), world, _worker,
            REFERENCE, [json.dumps(CASES), json.dumps(GRAPH),
                        json.dumps(CFG)], TIMEOUT)
        with open(data + ".json") as f:
            ref_stats = json.load(f)
        ranks = []
        for r in range(world):
            with open(port % r + ".json") as f:
                ranks.append((dict(np.load(port % r)), json.load(f)))
        out[world] = (dict(np.load(data)), ref_stats, ranks)
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["/".join(c) for c in CASES])
def test_sharded_matches_reference(runs, world, case):
    ref, _, ranks = runs[world]
    for res, _ in ranks:
        for backend in BACKENDS:
            np.testing.assert_array_equal(res[f"{case}_{backend}_labels"],
                                          ref[f"{case}_labels"])
            np.testing.assert_array_equal(res[f"{case}_{backend}_loads"],
                                          ref[f"{case}_loads"])
            np.testing.assert_array_equal(res[f"{case}_{backend}_meta"],
                                          ref[f"{case}_meta"])


@pytest.mark.parametrize("world", WORLDS)
def test_comm_stats_and_hostloop(runs, world):
    ref, ref_stats, ranks = runs[world]
    allgather = CASES.index(("allgather", "on", "replicated"))
    for res, stats in ranks:
        for f in ("src", "dst", "weight"):      # the same graph on both sides
            np.testing.assert_array_equal(res[f], ref[f])
        for i, want in ref_stats.items():
            got = stats[i]
            for key in set(want) - {"score_backend", "fused_update",
                                     "tile_config"}:
                assert got[key] == want[key], (i, key)
        # the host loop walks the same trajectory (allgather, no overlap)
        np.testing.assert_array_equal(res["hostloop_labels"],
                                      ref[f"{allgather}_labels"])
        assert int(res["hostloop_iterations"]) == int(
            ref[f"{allgather}_meta"][0])
