"""The sharded engine's layout, plans and world-size-1 runs against the
reference, in this process.

At world size 1 the port's mesh is a one-rank gloo group on an in-process
store (``make_partition_mesh(device="cpu")``) and the reference's a
1-device ``jax.sharding.Mesh``; every collective is then the identity, so
``partition(engine="sharded")`` must equal the reference's -- labels,
loads, iterations, halted and ``exchanged_bytes`` bit for bit -- for every
exchange plan, overlap schedule and score backend (the ``"cuda"`` backend
runs its kernels' plain versions on CPU tensors).  The numpy layout and the
plans are compared at 1/2/4/8 shards; world sizes 2 and 4 run end to end
in ``test_torch_multirank.py``.  The plain seeded proposal (K1's overlap
form) is held bitwise to the Pallas kernel with ``acc_init`` in interpret
mode on the reference's split tiling.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import EngineOptions as RefOptions
from repro.core import SpinnerConfig as RefConfig
from repro.core import comm as ref_comm
from repro.core import engine as ref_engine
from repro.core import generators as ref_gen
from repro.core import metrics as ref_metrics
from repro.core import partition as ref_partition
from repro.core.distributed import comm_stats as ref_comm_stats
from repro.core.distributed import run_sharded_hostloop as ref_hostloop
from repro.core.distributed import shard_graph as ref_shard_graph
from repro.core.graph import add_edges as ref_add_edges
from repro.core.session import open_session as ref_open
from repro.core.spinner import prepare_init as ref_prepare_init
from repro.kernels.ops import PallasTiledBackend
from repro.kernels.spinner_scores import (fused_update_from_tiles,
                                          spinner_scores_pallas)
from repro.launch.mesh import make_partition_mesh as ref_mesh
from repro_torch import rng
from repro_torch.convert import graph_from_reference
from repro_torch.core import EngineOptions, SpinnerConfig, comm, distributed
from repro_torch.core import engine, metrics, open_session, partition
from repro_torch.kernels import ref
from repro_torch.kernels.spinner_scores import (fused_update,
                                                fused_update_seeded)
from repro_torch.core.spinner import prepare_init
from repro_torch.launch.mesh import make_partition_mesh

PLANS = ("allgather", "halo", "halo_delta", "delta")
CFG = dict(k=6, seed=2, max_iters=60)


@pytest.fixture(scope="module")
def graphs():
    return {"ws": ref_gen.watts_strogatz(600, 8, 0.2, seed=11),
            "clustered": ref_gen.clustered_graph(8, 500, p_in=0.02,
                                                 p_out_edges_per_v=0.5,
                                                 seed=4),
            "powerlaw": ref_gen.powerlaw_ba(400, 5, seed=12)}


@pytest.fixture(scope="module")
def meshes():
    return ref_mesh(1), make_partition_mesh(device="cpu")


def _same(port, want):
    np.testing.assert_array_equal(port.labels, np.asarray(want.labels))
    np.testing.assert_array_equal(port.loads, np.asarray(want.loads))
    assert port.iterations == want.iterations
    assert port.halted == want.halted
    assert port.exchanged_bytes == want.exchanged_bytes
    assert port.total_messages == want.total_messages


# ---------------------------------------------------------------------------
# layout and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ws", "clustered", "powerlaw"])
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("pad", [False, True])
def test_shard_graph_matches_reference(graphs, name, ndev, pad):
    g = graphs[name]
    want = ref_shard_graph(g, ndev, pad=pad)
    got = distributed.shard_graph(graph_from_reference(g), ndev, pad=pad)
    for f in dataclasses.fields(want):
        if f.name.startswith("_"):
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert metrics.frontier_fraction(got) == ref_metrics.frontier_fraction(
        want)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("pad", [False, True])
def test_plans_match_reference(graphs, plan, ndev, pad):
    g = graphs["ws"]
    sg_ref = ref_shard_graph(g, ndev, pad=pad)
    sg = distributed.shard_graph(graph_from_reference(g), ndev, pad=pad)
    want = ref_comm.make_exchange_plan(plan, sg_ref, pad=pad)
    got = comm.make_exchange_plan(plan, sg, pad=pad)
    assert got is comm.make_exchange_plan(plan, sg, pad=pad)   # cached
    assert got.signature() == want.signature()
    assert comm.plan_from_signature(got.signature()).signature() \
        == want.signature()
    assert got.wire_bytes_per_iter() == want.wire_bytes_per_iter()
    np.testing.assert_array_equal(got.dst_index, np.asarray(want.dst_index))
    if plan in ("halo", "halo_delta"):
        assert got.true_halo == want.true_halo
        np.testing.assert_array_equal(got._send_idx, want._send_idx)
        np.testing.assert_array_equal(got._send_counts, want._send_counts)
        assert got.padded_wire_bytes_per_iter() \
            == want.padded_wire_bytes_per_iter()
    if plan == "delta":
        assert got.cap == want.cap


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("plan", ["allgather", "halo"])
def test_rank_shards_are_the_layout_rows(graphs, ndev, plan):
    """Each rank's device segments hold the real entries of its
    ``shard_graph`` row, in order, with the plan's dst index."""
    pg = graph_from_reference(graphs["powerlaw"])
    sg = distributed.shard_graph(pg, ndev)
    p = comm.make_exchange_plan(plan, sg)
    e = sg.e_interior
    for rank in range(ndev):
        fd = p.frontier_dst[rank] if plan == "halo" else None
        sh = distributed.rank_shard(pg, ndev, rank, "cpu", frontier_dst=fd,
                                    layout=(plan,))
        off = rank * sg.v_per_dev
        n_i, n_f = sg.interior_counts[rank], sg.frontier_counts[rank]
        rp, src, dst, w = sh.interior
        np.testing.assert_array_equal(src.numpy(), sg.src_local[rank, :n_i])
        np.testing.assert_array_equal(dst.numpy(),
                                      sg.dst[rank, :n_i] - off)
        np.testing.assert_array_equal(w.numpy(), sg.weight[rank, :n_i])
        np.testing.assert_array_equal(ref.csr_src(rp).numpy(), src.numpy())
        rp, src, dst, w = sh.frontier
        want_dst = (sg.dst if plan == "allgather" else p.dst_index)[
            rank, e:e + n_f]
        np.testing.assert_array_equal(src.numpy(),
                                      sg.src_local[rank, e:e + n_f])
        np.testing.assert_array_equal(dst.numpy(), want_dst)
        np.testing.assert_array_equal(sh.deg_w.numpy(), sg.deg_w[rank])
        assert int(sh.whole[0][-1]) == n_i + n_f


# ---------------------------------------------------------------------------
# K1's seeded form against the Pallas kernel with acc_init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
def test_seeded_propose_matches_pallas_acc_init(graphs, weighted):
    """On a 2-shard split tiling (the reference backend's overlap layout):
    the interior partial seeds the frontier pass; the plain seeded
    proposal equals the Pallas kernel (interpret mode) bit for bit, and
    equals the unseeded proposal over the whole shard."""
    g = graphs["ws"]
    k, ndev = 6, 2
    sg_ref = ref_shard_graph(g, ndev)
    backend = PallasTiledBackend(interpret=True)
    args = backend.sharded_fused_graph_args_split(sg_ref, k, sg_ref.dst)
    pg = graph_from_reference(g)
    gen = np.random.default_rng(5)
    lookup = gen.integers(0, k, sg_ref.num_vertices).astype(np.int32)
    vl = sg_ref.v_per_dev
    for rank in range(ndev):
        si, di, wi, sf, df, wf, perm, inv_perm, deg_t = (np.asarray(a[rank])
                                                         for a in args)
        labels = lookup[rank * vl:(rank + 1) * vl]
        noise = (gen.random((vl, k)) * 1e-7).astype(np.float32)
        pen = gen.random(k).astype(np.float32)
        partial = spinner_scores_pallas(si, labels[di], wi, tile_v=128,
                                        k_pad=128, interpret=True)
        want = fused_update_from_tiles(
            lookup, labels, deg_t, noise, np.ones(vl, bool), pen, sf, df,
            wf, perm, inv_perm, tile_v=128, k_pad=128, k=k,
            current_bonus=1e-6, degree_weighted=weighted, interpret=True,
            acc_init=partial)
        sh = distributed.rank_shard(pg, ndev, rank, "cpu")
        t = torch.from_numpy
        part = ref.interior_partial_ref(t(labels), sh.interior[0],
                                        sh.interior[2], sh.interior[3], k)
        common = (sh.deg_w, t(pen), t(noise), vl, k, 1e-6, weighted)
        got = fused_update_seeded(t(labels), sh.frontier[0], sh.frontier[2],
                                  sh.frontier[3], *common, part,
                                  lookup=t(lookup))
        whole = fused_update(t(labels), sh.whole[0], sh.whole[2],
                             sh.whole[3], *common, lookup=t(lookup))
        for a, b, c in zip(got, want, whole):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), c.numpy())


# ---------------------------------------------------------------------------
# whole runs at world size 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_runs(graphs, meshes):
    out = {}
    for name, plan, overlap in itertools.product(
            ("ws", "powerlaw"), PLANS, ("on", "off")):
        out[name, plan, overlap] = ref_partition(
            graphs[name], RefConfig(**CFG), record_history=False,
            engine="sharded", mesh=meshes[0],
            options=RefOptions(label_exchange=plan, overlap=overlap))
    return out


@pytest.mark.parametrize("name", ["ws", "powerlaw"])
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("overlap", ["on", "off"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_partition_sharded_matches_reference(graphs, meshes, ref_runs, name,
                                             plan, overlap, backend):
    got = partition(graph_from_reference(graphs[name]), SpinnerConfig(**CFG),
                    record_history=False, engine="sharded", mesh=meshes[1],
                    options=EngineOptions(device="cpu", label_exchange=plan,
                                          overlap=overlap,
                                          score_backend=backend))
    want = ref_runs[name, plan, overlap]
    _same(got, want)
    assert got.engine == "sharded" and got.exchanged_bytes == 0.0


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_one_device_mesh_reproduces_fused(graphs, backend):
    """The reference's 1-device law: the sharded run IS the fused run, on
    the default mesh too (``mesh=None``)."""
    pg = graph_from_reference(graphs["clustered"])
    cfg = SpinnerConfig(k=8, seed=4, max_iters=50)
    opts = EngineOptions(device="cpu", score_backend=backend)
    fused = partition(pg, cfg, record_history=False, engine="fused",
                      options=opts)
    sharded = partition(pg, cfg, record_history=False, engine="sharded",
                        options=opts)
    np.testing.assert_array_equal(fused.labels, sharded.labels)
    np.testing.assert_array_equal(fused.loads, sharded.loads)
    assert (fused.iterations, fused.halted, fused.total_messages) == (
        sharded.iterations, sharded.halted, sharded.total_messages)


def test_folded_noise_and_state_match_reference(graphs, meshes):
    """Folded noise; the final state's score within rtol 1e-5 (float32
    sums in another order) and the rest bit for bit."""
    g = graphs["ws"]
    pg = graph_from_reference(g)
    cfg = dict(CFG, seed=9)
    opts_r = RefOptions(sharded_noise="folded", overlap="on",
                        label_exchange="delta")
    r_labels, r_loads, r_key = ref_prepare_init(g, RefConfig(**cfg))
    want = ref_engine.run_sharded(g, RefConfig(**cfg), r_labels, r_loads,
                                  r_key, mesh=meshes[0], opts=opts_r)
    labels, loads, key = prepare_init(pg, SpinnerConfig(**cfg), device="cpu")
    got = engine.run_sharded(
        pg, SpinnerConfig(**cfg), labels, loads, key, mesh=meshes[1],
        opts=EngineOptions(device="cpu", sharded_noise="folded",
                           overlap="on", label_exchange="delta"))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.loads.numpy(), np.asarray(want.loads))
    for f in ("iteration", "halted", "stall", "migrations", "message_mass",
              "total_messages", "exchanged_bytes", "best_score"):
        assert getattr(got, f).item() == np.asarray(getattr(want, f)).item(), f
    assert got.score.item() == pytest.approx(float(want.score), rel=1e-5)
    assert tuple(got.key) == tuple(int(x) for x in np.asarray(want.key))


def test_fold_in_draws_differ_per_rank():
    key = rng.PRNGKey(3)
    assert rng.fold_in(key, 0) != rng.fold_in(key, 1)
    full = rng.uniform(key, (10, 3), device="cpu")
    part = rng.uniform(key, (4, 3), device="cpu", offset=5 * 3)
    assert torch.equal(full[5:9], part)


def test_hostloop_and_comm_stats_match_reference(graphs, meshes):
    g = graphs["powerlaw"]
    pg = graph_from_reference(g)
    want = ref_hostloop(g, RefConfig(**CFG), meshes[0])
    got = distributed.run_sharded_hostloop(
        pg, SpinnerConfig(**CFG), meshes[1],
        options=EngineOptions(device="cpu"))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.iteration) == int(want.iteration)
    for plan in PLANS:
        ro = RefOptions(label_exchange=plan)
        po = EngineOptions(device="cpu", label_exchange=plan)
        padded, _ = ref_engine.padded_view(g, ro)
        ws = ref_comm_stats(ref_shard_graph(padded, 1, pad=True),
                            RefConfig(**CFG), ro)
        gs = distributed.comm_stats(
            distributed.shard_graph(graph_from_reference(padded), 1,
                                    pad=True), SpinnerConfig(**CFG), po)
        for key in set(ws) - {"score_backend", "fused_update"}:
            assert gs[key] == ws[key], (plan, key)
    labels, stats = distributed.partition_distributed(
        pg, SpinnerConfig(**CFG), meshes[1],
        options=EngineOptions(device="cpu"))
    assert stats["iterations"] == int(want.iteration)
    assert stats["exchanged_bytes"] == 0.0
    np.testing.assert_array_equal(labels, np.asarray(want.labels)[:400])


# ---------------------------------------------------------------------------
# the session on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", ["on", "off"])
def test_session_on_mesh_matches_reference(graphs, meshes, overlap):
    g = graphs["powerlaw"]
    cfg = dict(k=4, seed=3, max_iters=40)
    rs = ref_open(g, RefConfig(**cfg),
                  RefOptions(mesh=meshes[0], overlap=overlap))
    ps = open_session(graph_from_reference(g), SpinnerConfig(**cfg),
                      EngineOptions(device="cpu", mesh=meshes[1],
                                    overlap=overlap))
    _same(ps.partition(), rs.partition())
    gen = np.random.default_rng(1)
    batch = (gen.integers(0, 400, 30), gen.integers(0, 400, 30))
    g2 = ref_add_edges(g, *batch, num_vertices=420)
    _same(ps.adapt(graph_from_reference(g2)), rs.adapt(g2))
    _same(ps.resize(6), rs.resize(6))
    # the CUDA backend's edge_updates take the fallback rebuild, as the
    # reference's Pallas backend does on a mesh; the reference's XLA
    # backend merges on the device without overlap, and so does the port's
    # torch backend (test_session_mesh_fast_paths_match_reference)
    batch = (gen.integers(0, 420, 12), gen.integers(0, 420, 12))
    _same(ps.adapt(edge_updates=batch), rs.adapt(edge_updates=batch))
    pd, rd = ps.stats(), rs.stats()
    keys = ("fast_adapts", "fallback_adapts", "host_rebuilds", "watermark")
    if overlap == "on":
        for key in keys:
            assert pd["delta"][key] == rd["delta"][key], key
        # stats() reads the base graph: both rebuilt it
        for key in set(rd["exchange"]) - {"score_backend", "fused_update"}:
            assert pd["exchange"][key] == rd["exchange"][key], key
    else:
        assert rd["delta"]["fast_adapts"] == 1
    assert (pd["delta"]["fast_adapts"], pd["delta"]["fallback_adapts"]) \
        == (0, 1)
    assert pd["last"]["engine"] == "sharded"


def test_session_mesh_paths_not_ported_raise(graphs, meshes):
    """The mesh paths this port has: a fast adapt and a frontier adapt on
    the session's mesh equal the reference's on its 1-device mesh, and
    run_app on the mesh too; the one it lacks, the cluster bootstrap's
    loading path (Slice F), still raises."""
    g = graphs["ws"]
    pg = graph_from_reference(g)
    s = open_session(pg, SpinnerConfig(k=4), EngineOptions(
        device="cpu", mesh=meshes[1], score_backend="torch", overlap="off"))
    rs = ref_open(g, RefConfig(k=4), RefOptions(mesh=meshes[0],
                                                overlap="off"))
    _same(s.partition(), rs.partition())
    for batch, frontier in ((([0], [5]), False), (([0], [7]), True)):
        got = s.adapt(edge_updates=batch, frontier=frontier)
        want = rs.adapt(edge_updates=batch, frontier=frontier)
        _same(got, want)
        assert got.scored_per_iter == want.scored_per_iter
        assert got.engine == want.engine == "sharded"
    d, rd = s.stats()["delta"], rs.stats()["delta"]
    assert d["fast_adapts"] == rd["fast_adapts"] == 2
    assert d["host_rebuilds"] == rd["host_rebuilds"] == 0
    # run_app on the session's mesh (its graph now holds both batches): the
    # reference session's on its 1-device mesh
    app = s.run_app("wcc")
    want = rs.run_app("wcc")
    assert (app.plan, app.ndev, app.supersteps, app.wire_bytes) == (
        want.plan, want.ndev, want.supersteps, want.wire_bytes)
    np.testing.assert_array_equal(app.values, want.values)
    np.testing.assert_array_equal(app.device_messages, want.device_messages)
    with pytest.raises(ValueError, match="engine='sharded'"):
        open_session(pg, SpinnerConfig(k=4), EngineOptions(
            device="cpu", mesh=meshes[1], engine="chunked")).partition()
    with pytest.raises(ValueError, match="history"):
        s.partition(record_history=True)
    # the per-host loading path refuses a graph holding another host's edges
    with pytest.raises(ValueError, match="local_only=0"):
        distributed.shard_graph(pg, 2, local_only=0)
    with pytest.raises(ValueError, match="devices"):
        make_partition_mesh(2, device="cpu")


def test_cuda_mesh_needs_nccl(meshes):
    """No collective stages a CUDA tensor through host memory: a CUDA mesh
    on a group without NCCL (gloo) is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import mesh_group
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    if "nccl" in str(dist.get_backend()).lower():
        assert mesh_group(mesh) is not None
    else:
        with pytest.raises(ValueError, match="NCCL"):
            mesh_group(mesh)


# ---------------------------------------------------------------------------
# continuous partitioning on a mesh: the sharded frontier runner and the
# session's delta fast path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def converged(graphs, meshes):
    """The ws graph's converged labels (the reference's sharded run)."""
    g = graphs["ws"]
    return np.array(ref_partition(
        g, RefConfig(**CFG), record_history=False, engine="sharded",
        mesh=meshes[0], options=RefOptions(label_exchange="allgather")
    ).labels)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("noise", ["replicated", "folded"])
def test_run_sharded_frontier_matches_reference(graphs, meshes, converged,
                                                plan, fused, noise):
    """From converged labels with 5% of the vertices active, to the drain:
    labels, loads, iterations, halted, exchanged bytes and the per-
    iteration scored counts bit for bit."""
    g = graphs["ws"]
    pg = graph_from_reference(g)
    cfg = dict(CFG, seed=5)
    active = np.random.default_rng(4).random(g.num_vertices) < 0.05
    ro = RefOptions(label_exchange=plan, fused_update=fused,
                    sharded_noise=noise, score_backend="xla")
    labels, loads, key = ref_prepare_init(g, RefConfig(**cfg), converged)
    want, hist = ref_engine.run_sharded_frontier(
        g, RefConfig(**cfg), labels, loads, key, active, mesh=meshes[0],
        opts=ro)
    po = EngineOptions(device="cpu", label_exchange=plan, fused_update=fused,
                       sharded_noise=noise, score_backend="torch")
    labels, loads, key = prepare_init(pg, SpinnerConfig(**cfg), converged,
                                      device="cpu")
    got, scored = engine.run_sharded_frontier(
        pg, SpinnerConfig(**cfg), labels, loads, key, active,
        mesh=meshes[1], opts=po)
    iters = int(want.iteration)
    assert bool(want.halted) and iters < cfg["max_iters"]   # it drained
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.loads.numpy(), np.asarray(want.loads))
    for f in ("iteration", "halted", "exchanged_bytes", "total_messages",
              "stall", "migrations"):
        assert getattr(got, f).item() == np.asarray(getattr(want, f)).item(), f
    assert scored == [float(x) for x in np.asarray(hist)[:iters]]


def test_sharded_frontier_needs_the_torch_backend(graphs, meshes):
    """The CUDA backend refuses the sharded frontier runner, as the
    reference's Pallas backend does, naming the torch backend; so does a
    session's adapt(frontier=True) on a mesh (after its fallback
    rebuild)."""
    pg = graph_from_reference(graphs["ws"])
    labels, loads, key = prepare_init(pg, SpinnerConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="'torch' score backend"):
        engine.run_sharded_frontier(
            pg, SpinnerConfig(**CFG), labels, loads, key,
            np.ones(pg.num_vertices, bool), mesh=meshes[1],
            opts=EngineOptions(device="cpu", score_backend="cuda"))
    s = open_session(pg, SpinnerConfig(**CFG), EngineOptions(
        device="cpu", mesh=meshes[1], score_backend="cuda", overlap="off"))
    s.partition()
    with pytest.raises(ValueError, match="'torch' score backend"):
        s.adapt(edge_updates=([0], [9]), frontier=True)
    assert s.stats()["delta"]["fallback_adapts"] == 1


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("fused", ["on", "off"])
def test_session_mesh_fast_paths_match_reference(graphs, meshes, plan,
                                                 fused):
    """At world size 1: the delta fast path on a mesh, dense and then
    frontier, against the reference's -- results, scored counts and the
    delta counters.  allgather and delta take the fast path on both sides;
    halo falls back on both; halo_delta falls back in the port only (the
    reference's fast path there is wrong beyond one device, ROADMAP.md
    §3), with the same results at world size 1."""
    g = graphs["clustered"]
    pg = graph_from_reference(g)
    cfg = dict(k=4, max_iters=83, seed=9, c=1.6)
    gen = np.random.default_rng(3)
    batches = [(gen.integers(0, 4000, 20), gen.integers(0, 4000, 20))
               for _ in range(2)]
    rs = ref_open(g, RefConfig(**cfg), RefOptions(
        mesh=meshes[0], label_exchange=plan, fused_update=fused,
        overlap="off", score_backend="xla"))
    ps = open_session(pg, SpinnerConfig(**cfg), EngineOptions(
        device="cpu", mesh=meshes[1], label_exchange=plan,
        fused_update=fused, overlap="off", score_backend="torch"))
    _same(ps.partition(), rs.partition())
    for batch, frontier in zip(batches, (False, True)):
        got = ps.adapt(edge_updates=batch, frontier=frontier)
        want = rs.adapt(edge_updates=batch, frontier=frontier)
        _same(got, want)
        assert got.scored_per_iter == want.scored_per_iter
    pd, rd = ps.stats()["delta"], rs.stats()["delta"]
    fast = plan in ("allgather", "delta")
    for key in ("fast_adapts", "fallback_adapts", "host_rebuilds",
                "watermark", "tracked_total_weight"):
        if fast or plan == "halo":
            assert pd[key] == rd[key], key
    assert (pd["fast_adapts"], pd["fallback_adapts"]) == (
        (2, 0) if fast else (0, 2))
    if fast:     # 12 bytes an appended entry, as at one device
        assert pd["upload_bytes_total"] % 12 == 0 and pd[
            "upload_bytes_total"] > 0


def test_one_rank_mesh_session_equals_single_device(graphs, meshes):
    """The premise of the card's phase (j1): on a 1-device mesh the
    reference's session gives its single-device session's results for
    partition, a frontier fast adapt and a dense fast adapt -- and so does
    the port's, against its own single-device session."""
    g = graphs["powerlaw"]
    pg = graph_from_reference(g)
    cfg = dict(k=6, seed=4, max_iters=70)
    gen = np.random.default_rng(8)
    b1 = (gen.integers(0, 400, 6), gen.integers(0, 400, 6))
    b2 = (gen.integers(0, 400, 40), gen.integers(0, 400, 40))
    sessions = {
        "ref_single": ref_open(g, RefConfig(**cfg), RefOptions(
            engine="fused", score_backend="xla")),
        "ref_mesh": ref_open(g, RefConfig(**cfg), RefOptions(
            mesh=meshes[0], overlap="off", score_backend="xla")),
        "single": open_session(pg, SpinnerConfig(**cfg), EngineOptions(
            engine="fused", device="cpu", score_backend="torch")),
        "mesh": open_session(pg, SpinnerConfig(**cfg), EngineOptions(
            mesh=meshes[1], device="cpu", overlap="off",
            score_backend="torch"))}
    out = {}
    for name, s in sessions.items():
        out[name] = [s.partition(record_history=False),
                     s.adapt(edge_updates=b1, frontier=True),
                     s.adapt(edge_updates=b2)]
        assert s.stats()["delta"]["fast_adapts"] == 2, name
    for name in ("ref_mesh", "single", "mesh"):
        for got, want in zip(out[name], out["ref_single"]):
            np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
            np.testing.assert_array_equal(got.loads, np.asarray(want.loads))
            assert (got.iterations, got.halted, got.scored_per_iter) == (
                want.iterations, want.halted, want.scored_per_iter), name
