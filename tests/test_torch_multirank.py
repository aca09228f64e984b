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

In the same processes both sides run the session's continuous
partitioning on the mesh (``delta_scenarios``): the reference's
``SHARDED_DELTA_FRONTIER`` calls (``tests/test_delta_frontier.py``) --
the delta fast path, dense and frontier, for the allgather and delta plans
x fused on/off x both noise modes, and halo's fallback frontier run -- a
batch whose entries all land on rank 0, a batch that overflows rank 0's
slack, and (at world size 2) the reference's ``halo_delta`` fast path,
whose result differs from its own rebuild: the port falls back there and
must equal the rebuild.
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
DELTA_GRAPH = dict(num_clusters=4, cluster_size=150, p_in=0.2,
                   p_out_edges_per_v=0.05, seed=2)
DELTA_CFG = dict(k=4, max_iters=83, seed=9, c=1.6)
DELTA_CASES = [(plan, fused, noise) for plan in ("allgather", "delta")
               for fused in ("off", "on")
               for noise in ("replicated", "folded")] + [
    ("halo", "off", "replicated")]
COUNTERS = ("fast_adapts", "fallback_adapts", "host_rebuilds", "watermark")


def delta_scenarios(core, generators, mesh, backend: str, world: int,
                    **device) -> dict:
    """The session's continuous partitioning on ``mesh`` through ``core``
    (``repro.core`` or ``repro_torch.core``): every result's labels,
    loads, ``[iterations, halted, exchanged_bytes, scored_vertices]``,
    ``scored_per_iter`` and the session's delta counters."""
    out = {}

    def keep(tag, res, sess):
        out[tag + "_labels"] = np.asarray(res.labels)
        out[tag + "_loads"] = np.asarray(res.loads)
        out[tag + "_meta"] = np.array([res.iterations, res.halted,
                                       res.exchanged_bytes,
                                       res.scored_vertices])
        out[tag + "_scored"] = np.asarray(res.scored_per_iter, np.float64)
        d = sess.stats()["delta"]
        out[tag + "_counters"] = np.array([d[c] for c in COUNTERS])

    def opts(plan, fused="off", noise="replicated"):
        return core.EngineOptions(
            engine="sharded", mesh=mesh, label_exchange=plan, overlap="off",
            fused_update=fused, sharded_noise=noise, score_backend=backend,
            **device)

    g = generators.clustered_graph(**DELTA_GRAPH)
    v = g.num_vertices
    cfg = core.SpinnerConfig(**DELTA_CFG)
    gen = np.random.default_rng(3)
    b = (gen.integers(0, v, 8), gen.integers(0, v, 8))
    for i, case in enumerate(DELTA_CASES):
        s = core.open_session(g, cfg, opts(*case))
        s.partition()
        s.adapt()
        keep(f"{i}_fixed", s.adapt(), s)
        if case[0] != "halo":
            keep(f"{i}_fast", s.adapt(edge_updates=b), s)
        s2 = core.open_session(g, cfg, opts(*case))
        s2.partition()
        s2.adapt()
        keep(f"{i}_frontier", s2.adapt(edge_updates=b, frontier=True), s2)
    # vertices 0..99 live on rank 0 at every world size here: the other
    # ranks merge nothing, then rank 0's slack overflows
    s = core.open_session(g, cfg, opts("delta", "on"))
    s.partition()
    keep("one_dense", s.adapt(edge_updates=(gen.integers(0, 100, 6),
                                            gen.integers(0, 100, 6))), s)
    keep("one_frontier", s.adapt(edge_updates=(gen.integers(0, 100, 6),
                                               gen.integers(0, 100, 6)),
                                 frontier=True), s)
    keep("overflow", s.adapt(edge_updates=(gen.integers(0, 100, 3000),
                                           gen.integers(0, 100, 3000)),
                             frontier=True), s)
    if world == 2:
        # the halo_delta fault (ROADMAP.md §3): the reference's fast path
        # against its own rebuild
        g = generators.watts_strogatz(2000, 8, 0.3, seed=1)
        cfg = core.SpinnerConfig(k=8, max_iters=60, seed=9)
        gen = np.random.default_rng(3)
        b = (gen.integers(0, 2000, 40), gen.integers(0, 2000, 40))
        prev = gen.integers(0, 8, 2000).astype(np.int32)
        s = core.open_session(g, cfg, opts("halo_delta"))
        keep("fault_fast", s.adapt(edge_updates=b, prev=prev), s)
        s = core.open_session(core.add_edges(g, *b), cfg, opts("halo_delta"))
        keep("fault_rebuild", s.adapt(prev=prev), s)
    return out

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
import repro.core
sys.path.insert(0, "tests")
from test_torch_multirank import delta_scenarios
np.savez(out + ".delta.npz", **delta_scenarios(repro.core, generators, mesh,
                                               "xla", ndev))
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
        import repro_torch.core
        np.savez(out % rank + ".delta.npz", **delta_scenarios(
            repro_torch.core, generators, mesh, "torch", world,
            device="cpu"))
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
                ranks.append((dict(np.load(port % r)), json.load(f),
                              dict(np.load(port % r + ".delta.npz"))))
        out[world] = (dict(np.load(data)), ref_stats, ranks,
                      dict(np.load(data + ".delta.npz")))
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["/".join(c) for c in CASES])
def test_sharded_matches_reference(runs, world, case):
    ref, _, ranks, _ = runs[world]
    for res, _, _ in ranks:
        for backend in BACKENDS:
            np.testing.assert_array_equal(res[f"{case}_{backend}_labels"],
                                          ref[f"{case}_labels"])
            np.testing.assert_array_equal(res[f"{case}_{backend}_loads"],
                                          ref[f"{case}_loads"])
            np.testing.assert_array_equal(res[f"{case}_{backend}_meta"],
                                          ref[f"{case}_meta"])


@pytest.mark.parametrize("world", WORLDS)
def test_comm_stats_and_hostloop(runs, world):
    ref, ref_stats, ranks, _ = runs[world]
    allgather = CASES.index(("allgather", "on", "replicated"))
    for res, stats, _ in ranks:
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


def _same_results(got: dict, want: dict, tag: str) -> None:
    for f in ("labels", "loads", "meta", "scored", "counters"):
        np.testing.assert_array_equal(got[f"{tag}_{f}"], want[f"{tag}_{f}"],
                                      err_msg=f"{tag}_{f}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(DELTA_CASES)),
                         ids=["/".join(c) for c in DELTA_CASES])
def test_session_delta_and_frontier_match_reference(runs, world, case):
    """The delta fast path (dense, then frontier in a second session) and
    halo's fallback frontier run, on every rank, equal the reference's:
    labels, loads, iterations, halted, exchanged bytes, scored counts and
    the delta counters."""
    _, _, ranks, ref = runs[world]
    plan = DELTA_CASES[case][0]
    for *_, got in ranks:
        tags = ["fixed", "frontier"] + (["fast"] if plan != "halo" else [])
        for tag in tags:
            _same_results(got, ref, f"{case}_{tag}")
        fast_frontier = (1, 0) if plan != "halo" else (0, 1)
        assert tuple(got[f"{case}_frontier_counters"][:2]) == fast_frontier
        assert got[f"{case}_frontier_meta"][3] \
            < 0.25 * 600 * max(1, got[f"{case}_frontier_meta"][0])


@pytest.mark.parametrize("world", WORLDS)
def test_batch_on_one_rank_and_overflow(runs, world):
    """A batch on rank 0 alone takes the fast path on every rank (dense and
    frontier); a batch that overflows rank 0's slack sends every rank to
    the fallback -- both as the reference decides."""
    _, _, ranks, ref = runs[world]
    for *_, got in ranks:
        for tag in ("one_dense", "one_frontier", "overflow"):
            _same_results(got, ref, tag)
        assert tuple(got["one_frontier_counters"][:3]) == (2, 0, 0)
        assert tuple(got["overflow_counters"][:2]) == (2, 1)


def test_halo_delta_falls_back_to_the_rebuild(runs):
    """At world size 2 the reference's halo_delta fast path writes global
    ids into halo slots and gives another result than its own rebuild; the
    port falls back and gives the rebuild's."""
    _, _, ranks, ref = runs[2]
    assert tuple(ref["fault_fast_counters"][:2]) == (1, 0)
    assert not np.array_equal(ref["fault_fast_labels"],
                              ref["fault_rebuild_labels"])
    for *_, got in ranks:
        assert tuple(got["fault_fast_counters"][:2]) == (0, 1)
        for f in ("labels", "loads", "meta"):
            np.testing.assert_array_equal(got[f"fault_fast_{f}"],
                                          ref[f"fault_rebuild_{f}"])
