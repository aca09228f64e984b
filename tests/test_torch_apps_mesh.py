"""The application engine on a mesh against the reference, on the CPU.

The placed layout at 2, 4 and 8 devices against ``repro.apps``'s
``AppLayout`` (placement, degrees, edge loads, each rank's interior and
frontier CSR against the reference's ``shard_graph`` row, the halo index);
the plain reduce and combine over a NON-EMPTY frontier against the Pallas
pair in interpret mode on a 2-way layout; ``run_app(mesh=...)`` at world
size 1 against the port's single-device run and the reference's 1-device
mesh; and at world sizes 2 and 4 (one process per rank in a gloo group,
``torch_spawn.run_world``) against ``repro.apps.run_app`` over forced
host devices, for every workload x exchange plan x overlap, on the
Spinner and hash placements and both combine backends: values (PageRank
within rtol 1e-4, atol 1e-9, the rest exactly), supersteps, converged,
``wire_bytes``, ``device_messages``, ``straggler_skew`` and
``edge_counts``.  Also ``pagerank_distributed`` and a session on the mesh.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import build_app_layout as ref_build_app_layout
from repro.apps import engine as ref_app_engine
from repro.apps import run_app as ref_run_app
from repro.core import comm as ref_comm
from repro.core import generators as ref_gen
from repro.core.spinner import SpinnerConfig as RefConfig
from repro.core.spinner import partition as ref_partition
from repro.kernels.pregel_combine import (combine_tiles_finish,
                                          combine_tiles_interior)
from repro.launch.mesh import make_partition_mesh as ref_mesh
from repro_torch.apps import build_app_layout, run_app
from repro_torch.convert import graph_from_reference
from repro_torch.core import comm
from repro_torch.kernels import ref
from repro_torch.launch.mesh import make_partition_mesh
from torch_spawn import run_world

WORLDS = (2, 4)
GRAPH = dict(n=600, k=8, p=0.2, seed=11)
K = 4
WORKLOADS = ("pagerank", "wcc", "bfs", "sssp")
PLANS = ("allgather", "halo", "halo_delta", "delta")
PLACEMENTS = ("spinner", "hash")
BACKENDS = ("cuda", "torch")
RUN_KW = {"pagerank": dict(iters=12), "wcc": {}, "bfs": dict(source=17),
          "sssp": dict(source=3)}
CASES = [(wl, plan, overlap, place) for wl in WORKLOADS for plan in PLANS
         for overlap in (True, False) for place in PLACEMENTS]
SESSION_CFG = dict(k=K, seed=2, max_iters=60)
TIMEOUT = 300
DAMPING = 0.85
TILE = 128


def hash_labels(v: int, k: int) -> np.ndarray:
    return (np.arange(v) * np.int64(2654435761) % k).astype(np.int32)


@pytest.fixture(scope="module")
def ws_graph():
    return ref_gen.watts_strogatz(GRAPH["n"], GRAPH["k"], GRAPH["p"],
                                  seed=GRAPH["seed"])


@pytest.fixture(scope="module")
def placements(ws_graph):
    spinner = ref_partition(ws_graph, RefConfig(k=K, seed=1, max_iters=60),
                            record_history=False).labels
    return {"spinner": np.asarray(spinner, np.int32),
            "hash": hash_labels(ws_graph.num_vertices, K)}


def assert_same_run(got, want):
    """Values (PageRank within tolerance) and every accounting field."""
    assert (got.workload, got.plan, got.ndev) == (want.workload, want.plan,
                                                  want.ndev)
    assert got.supersteps == want.supersteps
    assert got.converged == want.converged
    if got.workload == "pagerank":
        np.testing.assert_allclose(got.values, want.values, rtol=1e-4,
                                   atol=1e-9)
    else:
        assert got.values.dtype == want.values.dtype
        np.testing.assert_array_equal(got.values, want.values)
    assert got.wire_bytes == want.wire_bytes
    assert got.wire_bytes_per_step == want.wire_bytes_per_step
    np.testing.assert_array_equal(got.device_messages, want.device_messages)
    assert got.straggler_skew == want.straggler_skew
    np.testing.assert_array_equal(got.edge_counts, want.edge_counts)


# ---------------------------------------------------------------------------
# The layout at ndev > 1
# ---------------------------------------------------------------------------

def _expand(row_ptr: torch.Tensor) -> np.ndarray:
    return ref.csr_src(row_ptr).numpy()


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("place", PLACEMENTS)
def test_layout_matches_reference(ws_graph, placements, ndev, place):
    """Placement, degrees, loads, and each rank's interior / frontier CSR
    (global ids and the halo plan's slots) against the reference's
    ``shard_graph`` row; the halo counted on the device against the
    reference's ``HaloPlan.true_halo``."""
    lab = placements[place]
    want = ref_build_app_layout(ws_graph, lab, ndev)
    g = graph_from_reference(ws_graph)
    got = build_app_layout(g, lab, "cpu", ndev=ndev)
    assert build_app_layout(g, lab, "cpu", ndev=ndev) is got
    assert (got.v_pad, got.v_per_dev, got.num_real) == (
        want.v_pad, want.v_per_dev, want.num_real)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.deg_cnt.view(ndev, -1).numpy(),
                                  want.deg_cnt)
    np.testing.assert_array_equal(got.edge_counts, want.edge_counts)
    np.testing.assert_array_equal(got.row_ptr.numpy(), want.pgraph.row_ptr)
    np.testing.assert_array_equal(got.dst.numpy(), want.pgraph.dst)
    sg = want.sg
    halo = got.exchange_plan(g, "halo")
    ref_halo = ref_comm.make_exchange_plan("halo", sg, pad=True)
    assert (halo.halo_size, halo.true_halo) == (ref_halo.halo_size,
                                                ref_halo.true_halo)
    assert got.halo_count() == ref_halo.true_halo
    e, vl = sg.e_interior, sg.v_per_dev
    assert sg.frontier_counts.sum() > 0
    for p in range(ndev):
        n_i, n_f = int(sg.interior_counts[p]), int(sg.frontier_counts[p])
        valid = np.arange(vl) < want.counts[p]
        for plan in (None, halo):
            sh = got.shard(p, plan)
            assert (sh.rank, sh.v_local, sh.offset) == (p, vl, p * vl)
            np.testing.assert_array_equal(_expand(sh.interior[0]),
                                          sg.src_local[p, :n_i])
            np.testing.assert_array_equal(sh.interior[1].numpy(),
                                          sg.dst[p, :n_i] - p * vl)
            np.testing.assert_array_equal(_expand(sh.frontier[0]),
                                          sg.src_local[p, e:e + n_f])
            index = sg.dst if plan is None else ref_halo.dst_index
            np.testing.assert_array_equal(sh.frontier[1].numpy(),
                                          index[p, e:e + n_f])
            np.testing.assert_array_equal(sh.valid.numpy(), valid)
            np.testing.assert_array_equal(sh.deg_cnt.numpy(),
                                          want.deg_cnt[p])
        assert got.shard(p, halo) is got.shard(
            p, got.exchange_plan(g, "halo_delta"))


def test_layout_refuses_what_it_cannot_place(ws_graph, placements):
    g = graph_from_reference(ws_graph)
    lab = placements["spinner"]
    with pytest.raises(ValueError, match="equal ranges"):
        build_app_layout(g, lab, "cpu", ndev=3)   # v_pad 640
    lay = build_app_layout(g, lab, "cpu", ndev=2)
    with pytest.raises(ValueError, match="shard"):
        lay.frontier_dst
    with pytest.raises(ValueError, match="rank"):
        lay.shard(2)
    with pytest.raises(ValueError, match="unknown exchange plan"):
        lay.exchange_plan(g, "broadcast")


# ---------------------------------------------------------------------------
# The plain pair over a non-empty frontier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload,combine,update,bias",
                         [("pagerank", "sum", "pagerank", 0),
                          ("wcc", "min", "min", 0), ("bfs", "min", "min", 1)])
def test_plain_pair_matches_pallas_pair_on_a_frontier(
        ws_graph, placements, workload, combine, update, bias):
    """Each rank of a 2-way hash layout (half its edges cross): the plain
    reduce over the interior, then the plain combine over the frontier
    seeded by it, against the reference's ``combine_tiles_interior`` ->
    ``combine_tiles_finish`` (interpret mode) on the same send vector."""
    lab = placements["hash"]
    rl = ref_build_app_layout(ws_graph, lab, 2)
    pl = build_app_layout(graph_from_reference(ws_graph), lab, "cpu", ndev=2)
    plan = ref_comm.make_exchange_plan("allgather", rl.sg, pad=True)
    args = ref_app_engine._pallas_app_args(rl.sg, plan, TILE, TILE)
    gen = np.random.default_rng(7 + bias)
    v = rl.v_pad
    if combine == "sum":
        send = gen.uniform(0.0, 1e-3, v).astype(np.float32)
        values = gen.uniform(0.0, 1e-3, v).astype(np.float32)
    else:
        send = gen.integers(0, rl.num_real, v).astype(np.int32)
        send[gen.random(v) < 0.3] = ref.INF_I32
        values = gen.integers(0, rl.num_real, v).astype(np.int32)
    base = np.float32((1.0 - DAMPING) / rl.num_real)
    vl = rl.v_per_dev
    for p in range(2):
        rows = slice(p * vl, (p + 1) * vl)
        si, ii, wmi, sf, fi, wmf, perm, inv_perm = (a[p] for a in args)
        valid = np.arange(vl) < rl.counts[p]
        partial_t = combine_tiles_interior(
            jnp.asarray(send[rows]), si, ii, wmi, tile_v=TILE,
            combine=combine, bias=bias, interpret=True)
        want_new, want_chg = combine_tiles_finish(
            partial_t, jnp.asarray(send), jnp.asarray(values[rows]),
            jnp.asarray(valid), jnp.float32(base), sf, fi, wmf, perm,
            inv_perm, tile_v=TILE, combine=combine, update=update,
            damping=DAMPING, bias=bias, interpret=True)
        sh = pl.shard(p)
        assert sh.frontier[1].numel() > 0
        t = torch.from_numpy
        partial = ref.pregel_reduce_ref(t(send[rows]), *sh.interior,
                                        combine=combine, bias=bias)
        new, chg = ref.pregel_combine_ref(
            t(send), *sh.frontier, t(values[rows]), sh.valid, float(base),
            combine=combine, update=update, damping=DAMPING, bias=bias,
            acc_init=partial)
        want_partial = np.asarray(partial_t).reshape(-1)[np.asarray(perm)]
        if combine == "min":
            np.testing.assert_array_equal(partial.numpy(), want_partial)
            np.testing.assert_array_equal(new.numpy(), np.asarray(want_new))
        else:
            np.testing.assert_allclose(partial.numpy(), want_partial,
                                       rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(new.numpy(), np.asarray(want_new),
                                       rtol=1e-5, atol=1e-9)
        np.testing.assert_array_equal(chg.numpy(), np.asarray(want_chg))


# ---------------------------------------------------------------------------
# World size 1, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", PLANS)
def test_world_one_matches_single_device_and_reference(ws_graph, placements,
                                                       plan):
    """A one-rank mesh: the same run as without a mesh and as the
    reference's 1-device mesh, with nothing on the wire, under both
    schedules and both combine backends."""
    g = graph_from_reference(ws_graph)
    mesh, rmesh = make_partition_mesh(1, device="cpu"), ref_mesh(1)
    lab = placements["spinner"]
    for wl in WORKLOADS:
        alone = run_app(g, lab, wl, device="cpu", **RUN_KW[wl])
        for overlap in (True, False):
            want = ref_run_app(ws_graph, lab, wl, mesh=rmesh, plan=plan,
                               overlap=overlap, **RUN_KW[wl])
            assert want.wire_bytes == 0.0
            for backend in BACKENDS:
                got = run_app(g, lab, wl, mesh=mesh, plan=plan,
                              overlap=overlap, combine=backend,
                              device="cpu", **RUN_KW[wl])
                assert_same_run(got, want)
                assert got.supersteps == alone.supersteps
                np.testing.assert_array_equal(got.values, alone.values)
                np.testing.assert_array_equal(got.device_messages,
                                              alone.device_messages)


def test_mesh_options_are_validated(ws_graph, placements):
    g = graph_from_reference(ws_graph)
    lab = placements["spinner"]
    mesh = make_partition_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="pass mesh="):
        run_app(g, lab, "wcc", plan="halo", device="cpu")
    with pytest.raises(ValueError, match="the mesh is on"):
        run_app(g, lab, "wcc", mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="unknown exchange plan"):
        run_app(g, lab, "wcc", mesh=mesh, plan="broadcast")
    with pytest.raises(ValueError, match="no axis"):
        run_app(g, lab, "wcc", mesh=mesh, axis="model")
    res = run_app(g, lab, "pagerank", mesh=mesh)
    assert res.plan == "halo"                     # the workload's default
    assert run_app(g, lab, "bfs", mesh=mesh).plan == "halo_delta"


def test_delta_plan_sends_float_bits_exactly():
    """The delta plan packs indices and values into one int32 buffer:
    float values travel bit-cast, so the mirror receives their exact bits
    (subnormals, a NaN's payload) and the indices never round through
    float32."""
    mesh = make_partition_mesh(1, device="cpu")
    from repro_torch.launch.mesh import mesh_group
    c = comm.Comm(group=mesh_group(mesh), rank=0, ndev=1)
    from repro_torch.core.distributed import ShardGeometry
    geo = ShardGeometry(num_vertices=64, num_real_vertices=64, ndev=1,
                        v_per_dev=64)
    plan = comm.DeltaPlan(geo, cap=8)
    old = torch.zeros(64)
    new = old.clone()
    bits = np.array([0x80000001, 0x00000001, 0x7FC12345, 0x3F800001],
                    np.uint32).view(np.float32)
    new[[3, 17, 40, 63]] = torch.from_numpy(bits)
    pending = plan.start_exchange(new, plan.init_aux(old, c), c)
    mode, (_, inbox), _, wire = pending
    assert mode == "compact" and inbox.dtype == torch.int32
    lookup, _, _ = plan.finish_exchange(pending)
    assert lookup.dtype == torch.float32
    assert torch.equal(lookup.view(torch.int32), new.view(torch.int32))
    assert float(wire) == 0.0                     # one rank: nothing leaves


# ---------------------------------------------------------------------------
# World sizes 2 and 4: one spawn per world size, every case inside
# ---------------------------------------------------------------------------

REFERENCE = """
import json, sys
import numpy as np
from repro.apps import run_app
from repro.core import EngineOptions, SpinnerConfig, generators
from repro.core import open_session
from repro.core.pregel_dist import pagerank_distributed
from repro.launch.mesh import make_partition_mesh
ndev, out, labels, cases, graph, run_kw, cfg = (
    int(sys.argv[1]), sys.argv[2], np.load(sys.argv[3]),
    json.loads(sys.argv[4]), json.loads(sys.argv[5]),
    json.loads(sys.argv[6]), json.loads(sys.argv[7]))
g = generators.watts_strogatz(graph["n"], graph["k"], graph["p"],
                              seed=graph["seed"])
mesh = make_partition_mesh(ndev)
res, meta = {}, {}

def keep(tag, r):
    res[tag + "_values"] = r.values
    res[tag + "_msgs"] = r.device_messages
    res[tag + "_edges"] = r.edge_counts
    meta[tag] = [r.workload, r.plan, r.ndev, r.supersteps, r.converged,
                 r.wire_bytes, r.wire_bytes_per_step, r.straggler_skew]

for i, (wl, plan, overlap, place) in enumerate(cases):
    keep(str(i), run_app(g, labels[place], wl, mesh=mesh, plan=plan,
                         overlap=overlap, **run_kw[wl]))
for place in ("spinner", "hash"):
    vals, stats = pagerank_distributed(g, labels[place], mesh, iters=12)
    res["prd_" + place] = vals
    meta["prd_" + place] = stats
s = open_session(g, SpinnerConfig(**cfg), EngineOptions(engine="sharded",
                                                        mesh=mesh))
res["session_labels"] = s.partition().labels
keep("session_wcc", s.run_app("wcc"))
keep("session_pagerank", s.run_app("pagerank", iters=12, plan="delta"))
np.savez(out, **res)
with open(out + ".json", "w") as f:
    json.dump(meta, f)
"""


def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank of the port: every case on both combine backends."""
    import os

    import torch.distributed as dist

    from repro_torch.apps import run_app
    from repro_torch.core import (EngineOptions, SpinnerConfig, generators,
                                  open_session)
    from repro_torch.core.pregel_dist import pagerank_distributed
    from repro_torch.launch.mesh import make_partition_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        labels = np.load(os.path.join(os.path.dirname(out), "labels.npz"))
        g = generators.watts_strogatz(GRAPH["n"], GRAPH["k"], GRAPH["p"],
                                      seed=GRAPH["seed"])
        mesh = make_partition_mesh(device="cpu")
        res, meta = {}, {}

        def keep(tag, r):
            res[tag + "_values"] = r.values
            res[tag + "_msgs"] = r.device_messages
            res[tag + "_edges"] = r.edge_counts
            meta[tag] = [r.workload, r.plan, r.ndev, r.supersteps,
                         r.converged, r.wire_bytes, r.wire_bytes_per_step,
                         r.straggler_skew]

        for i, (wl, plan, overlap, place) in enumerate(CASES):
            for backend in BACKENDS:
                keep(f"{i}_{backend}", run_app(
                    g, labels[place], wl, mesh=mesh, plan=plan,
                    overlap=overlap, combine=backend, **RUN_KW[wl]))
        for place in PLACEMENTS:
            vals, stats = pagerank_distributed(g, labels[place], mesh,
                                               iters=12)
            res["prd_" + place] = vals
            meta["prd_" + place] = stats
        s = open_session(g, SpinnerConfig(**SESSION_CFG), EngineOptions(
            device="cpu", engine="sharded", mesh=mesh))
        res["session_labels"] = s.partition().labels
        keep("session_wcc", s.run_app("wcc"))
        keep("session_pagerank", s.run_app("pagerank", iters=12,
                                           plan="delta"))
        np.savez(out % rank, **res)
        with open(out % rank + ".json", "w") as f:
            json.dump(meta, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, placements):
    """Per world size: the reference's (arrays, meta) and each rank's."""
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"apps{world}")
        labels = str(tmp / "labels.npz")
        np.savez(labels, **placements)
        data, port = run_world(
            tmp, world, _worker, REFERENCE,
            [labels, json.dumps(CASES), json.dumps(GRAPH),
             json.dumps(RUN_KW), json.dumps(SESSION_CFG)], TIMEOUT)
        with open(data + ".json") as f:
            ref_meta = json.load(f)
        ranks = []
        for r in range(world):
            with open(port % r + ".json") as f:
                ranks.append((dict(np.load(port % r)), json.load(f)))
        out[world] = (dict(np.load(data)), ref_meta, ranks)
    return out


# PageRank under the plans that send only CHANGED values: which float32
# values changed bitwise follows the sums' rounding, and the reference sums
# in another order, so a value that moved by about an ulp can count on one
# side only (one or two values a run here).  Its wire bytes are held within
# this tolerance; every other plan and workload exactly.
PAGERANK_CHANGED_WIRE_RTOL = 1e-3


def _assert_same(res, meta, tag, ref, ref_meta, ref_tag):
    got, want = meta[tag], ref_meta[ref_tag]
    if got[0] == "pagerank" and got[1] in ("halo_delta", "delta"):
        np.testing.assert_allclose(got[5:7], want[5:7],
                                   rtol=PAGERANK_CHANGED_WIRE_RTOL,
                                   err_msg=tag)
        got, want = got[:5] + got[7:], want[:5] + want[7:]
    assert got == want, (tag, got, want)
    values = res[tag + "_values"]
    if got[0] == "pagerank":
        np.testing.assert_allclose(values, ref[ref_tag + "_values"],
                                   rtol=1e-4, atol=1e-9)
    else:
        np.testing.assert_array_equal(values, ref[ref_tag + "_values"])
    for f in ("_msgs", "_edges"):
        np.testing.assert_array_equal(res[tag + f], ref[ref_tag + f])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["/".join(map(str, c)) for c in CASES])
def test_run_app_on_a_mesh_matches_reference(runs, world, case):
    """Every rank returns the reference's result, on both backends."""
    ref, ref_meta, ranks = runs[world]
    for res, meta in ranks:
        for backend in BACKENDS:
            _assert_same(res, meta, f"{case}_{backend}", ref, ref_meta,
                         str(case))
            assert meta[f"{case}_{backend}"][2] == world


@pytest.mark.parametrize("world", WORLDS)
def test_spinner_moves_fewer_wire_bytes_than_hash(runs, world):
    """The paper's Section 7 mechanism: under the halo plans, Spinner's
    placement puts fewer bytes on the wire than the hash placement, for
    the same supersteps; allgather and delta move the same bytes under
    both (the whole vector, or every changed value to every rank)."""
    _, ref_meta, ranks = runs[world]
    _, meta = ranks[0]
    for wl in WORKLOADS:
        for plan in PLANS:
            tags = {place: str(CASES.index((wl, plan, True, place)))
                    for place in PLACEMENTS}
            spinner, hashed = (meta[tags[p] + "_cuda"] for p in PLACEMENTS)
            assert spinner[3] == hashed[3]
            if plan == "allgather" or (plan == "delta"
                                       and wl != "pagerank"):
                assert spinner[5] == hashed[5] > 0
            elif plan == "delta":
                np.testing.assert_allclose(
                    spinner[5], hashed[5], rtol=PAGERANK_CHANGED_WIRE_RTOL)
            else:
                assert 0 < spinner[5] < hashed[5], (wl, plan)
                assert ref_meta[tags["spinner"]][5] < \
                    ref_meta[tags["hash"]][5]


@pytest.mark.parametrize("world", WORLDS)
def test_pagerank_distributed_and_session_match_reference(runs, world):
    ref, ref_meta, ranks = runs[world]
    for res, meta in ranks:
        for place in PLACEMENTS:
            tag = "prd_" + place
            np.testing.assert_allclose(res[tag], ref[tag], rtol=1e-4,
                                       atol=1e-9)
            assert meta[tag] == ref_meta[tag]
        assert meta["prd_spinner"]["wire_bytes"] < \
            meta["prd_hash"]["wire_bytes"]
        np.testing.assert_array_equal(res["session_labels"],
                                      ref["session_labels"])
        for tag in ("session_wcc", "session_pagerank"):
            _assert_same(res, meta, tag, ref, ref_meta, tag)
