"""The CUDA kernels and the port's main path on a card.

Every test here needs a CUDA card and skips without one; they import
neither JAX nor the reference package, so they run where only PyTorch
is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CPU tests hold the port's plain versions and CPU runs to the
reference bit for bit; these hold the kernels and the card's runs to the
plain versions and CPU runs, bit for bit.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.apps import build_app_layout, run_app
from repro_torch.core import (EngineOptions, SpinnerConfig, delta,
                              distributed, engine, generators, open_session,
                              partition, prepare_init)
from repro_torch.core.graph import _finish
from repro_torch.kernels import autotune, ref, threefry
from repro_torch.kernels.ops import CudaCsrBackend
from repro_torch.kernels.pregel_combine import pregel_combine, pregel_reduce
from repro_torch.kernels.spinner_scores import (clip_tile, fused_update,
                                                fused_update_frontier,
                                                fused_update_seeded,
                                                scores_layout,
                                                spinner_scores, tile_grid)
from repro_torch.launch.mesh import make_partition_mesh

pytestmark = pytest.mark.gpu

KS = [2, 7, 32, 130]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def padded():
    """A hub-heavy graph on its bucketed layout (weight-0 pad entries)."""
    g = generators.powerlaw_ba(400, 5, seed=2)
    return engine.padded_view(g, EngineOptions(device="cpu"))


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("k", KS)
def test_kernels_bitwise(cuda, padded, k):
    g, num_real = padded
    csr = g.to_device(cuda)
    gen = np.random.default_rng(7 * k)
    labels = torch.from_numpy(
        gen.integers(0, k, g.num_vertices).astype(np.int32)).to(cuda)
    pen = torch.from_numpy(gen.uniform(0.8, 1.2, k).astype(np.float32)
                           ).to(cuda)
    noise = rng.uniform(rng.PRNGKey(k), (g.num_vertices, k), 0.0, 1e-7,
                        device=cuda)
    n2 = spinner_scores.launches
    got = spinner_scores(labels, csr.row_ptr, csr.dst, csr.weight, k)
    assert spinner_scores.launches == n2 + 1
    want = ref.spinner_scores_ref(labels, csr.src, csr.dst, csr.weight,
                                  g.num_vertices, k)
    assert _bits_equal(got, want)
    for weighted in (True, False):
        n1 = fused_update.launches
        got = fused_update(labels, csr.row_ptr, csr.dst, csr.weight,
                           csr.deg_w, pen, noise, num_real, k, 1e-6, weighted)
        assert fused_update.launches == n1 + 1
        want = ref.fused_propose_ref(labels, csr.src, csr.dst, csr.weight,
                                     csr.deg_w, pen, noise, num_real, k,
                                     1e-6, weighted)
        assert all(_bits_equal(a, b) for a, b in zip(got, want))


def test_wrapper_rejects_mixed_devices(cuda, padded):
    g, _ = padded
    csr = g.to_device(cuda)
    labels = torch.zeros(g.num_vertices, dtype=torch.int32)   # on the CPU
    with pytest.raises(ValueError):
        spinner_scores(labels, csr.row_ptr, csr.dst, csr.weight, 4)


def test_rng_on_card_matches_cpu(cuda):
    key = rng.split(rng.PRNGKey(2**32 + 5))[1]
    for shape in [(7,), (1001, 33)]:
        a = rng.uniform(key, shape, 0.0, 1e-7, device=cuda).cpu()
        b = rng.uniform(key, shape, 0.0, 1e-7, device="cpu")
        assert _bits_equal(a, b)
    assert torch.equal(rng.randint(key, (999,), 0, 130, device=cuda).cpu(),
                       rng.randint(key, (999,), 0, 130, device="cpu"))


@pytest.mark.parametrize("engine_name", ["fused", "host"])
def test_partition_on_card_matches_cpu(cuda, engine_name):
    """Every backend on the card walks the CPU run's trajectory (which the
    CPU tests hold to the reference); the fused kernel launches once per
    iteration."""
    g = generators.watts_strogatz(3000, 10, 0.25, seed=7)
    cfg = SpinnerConfig(k=8, seed=3)
    want = partition(g, cfg, engine=engine_name, record_history=False,
                     device="cpu")
    for backend, fused in (("cuda", "auto"), ("cuda", "off"),
                           ("torch", "auto")):
        fused_update.launches = spinner_scores.launches = 0
        got = partition(g, cfg, engine=engine_name, record_history=False,
                        options=EngineOptions(device=cuda,
                                              score_backend=backend,
                                              fused_update=fused))
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.loads, want.loads)
        assert (got.iterations, got.halted) == (want.iterations, want.halted)
        launched = {("cuda", "auto"): fused_update.launches,
                    ("cuda", "off"): spinner_scores.launches,
                    ("torch", "auto"): 0}[backend, fused]
        expected = got.iterations if backend == "cuda" else 0
        assert launched == expected
        assert fused_update.launches + spinner_scores.launches == expected


# (combine, update, bias) of the Pregel workloads
PREGEL = [("sum", "pagerank", 0), ("min", "min", 0), ("min", "min", 1)]


@pytest.mark.parametrize("combine,update,bias", PREGEL)
def test_pregel_kernels_match_plain(cuda, combine, update, bias):
    """Both combine kernels, with and without a seed, over the full CSR
    and the empty frontier: min bitwise, sum within float32 tolerance and
    bitwise equal to itself across launches."""
    g = generators.powerlaw_ba(3000, 5, seed=4)        # hub rows > 32 edges
    labels = np.random.default_rng(1).integers(0, 8, g.num_vertices)
    lay = build_app_layout(g, labels, cuda)
    gen = np.random.default_rng(9 + bias)
    v = lay.v_pad
    if combine == "sum":
        arrays = [gen.uniform(0, 1e-3, v).astype(np.float32)
                  for _ in range(3)]
    else:
        arrays = [gen.integers(0, g.num_vertices, v).astype(np.int32)
                  for _ in range(3)]
        for a in arrays:
            a[gen.random(v) < 0.3] = ref.INF_I32
    send, values, init = (torch.from_numpy(a).to(cuda) for a in arrays)
    base = float(np.float32(0.15 / g.num_vertices))

    def same(a, b):
        if combine == "min" or a.dtype == torch.bool:
            return torch.equal(a, b)
        return torch.allclose(a, b, rtol=1e-5, atol=1e-9)

    csrs = ((lay.row_ptr, lay.dst), (lay.frontier_row_ptr, lay.frontier_dst))
    for (rp, dst), seed in ((c, s) for c in csrs for s in (None, init)):
        n = pregel_reduce.launches
        got = pregel_reduce(send, rp, dst, combine=combine, bias=bias,
                            acc_init=seed)
        again = pregel_reduce(send, rp, dst, combine=combine, bias=bias,
                              acc_init=seed)
        assert pregel_reduce.launches == n + 2
        assert _bits_equal(got, again)
        assert same(got, ref.pregel_reduce_ref(send, rp, dst,
                                               combine=combine, bias=bias,
                                               acc_init=seed))
        kw = dict(combine=combine, update=update, damping=0.85, bias=bias,
                  acc_init=seed)
        n = pregel_combine.launches
        got = pregel_combine(send, rp, dst, values, lay.valid, base, **kw)
        again = pregel_combine(send, rp, dst, values, lay.valid, base, **kw)
        assert pregel_combine.launches == n + 2
        assert all(_bits_equal(a, b) for a, b in zip(got, again))
        want = ref.pregel_combine_ref(send, rp, dst, values, lay.valid,
                                      base, **kw)
        assert all(same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("workload", ["pagerank", "wcc", "bfs", "sssp"])
def test_run_app_on_card_matches_cpu(cuda, workload):
    """The card's run walks the CPU run (which the CPU tests hold to the
    reference); each kernel launches once per superstep."""
    g = generators.watts_strogatz(3000, 10, 0.25, seed=7)
    labels = (np.arange(g.num_vertices) * 2654435761 % 8).astype(np.int32)
    want = run_app(g, labels, workload, device="cpu")
    pregel_reduce.launches = pregel_combine.launches = 0
    got = run_app(g, labels, workload, device=cuda)
    assert pregel_reduce.launches == pregel_combine.launches \
        == got.supersteps == want.supersteps
    assert got.converged == want.converged
    if workload == "pagerank":
        np.testing.assert_allclose(got.values, want.values, rtol=1e-4,
                                   atol=1e-9)
    else:
        np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.device_messages, want.device_messages)
    torch_run = run_app(g, labels, workload, combine="torch", device=cuda)
    assert torch_run.supersteps == got.supersteps


def _halo_lookup(plan, send, rank, ndev, vl):
    """The ``[local | halo]`` lookup the halo exchange would assemble on
    ``rank`` from the whole send vector."""
    send_idx = torch.from_numpy(plan._send_idx.astype(np.int64)).to(
        send.device)                              # (owner, needer, H)
    owners = torch.arange(ndev, device=send.device)[:, None] * vl
    halo = send[owners + send_idx[:, rank]].reshape(-1)
    return torch.cat([send[rank * vl:(rank + 1) * vl], halo])


@pytest.mark.parametrize("ndev", [2, 3, 4])
@pytest.mark.parametrize("combine,update,bias", PREGEL)
def test_pregel_kernels_on_app_shards_match_plain(cuda, ndev, combine,
                                                  update, bias):
    """Each rank of an n-way app layout: K3 over its interior, then K4
    over its frontier (non-empty) seeded by K3's partial, reading the
    whole send vector (allgather/delta index) and the halo lookup: min
    bitwise, sum within rtol 1e-5 and bitwise repeatable."""
    g = generators.powerlaw_ba(3000, 5, seed=4)        # v_pad 3072
    labels = np.random.default_rng(2).integers(0, 8, g.num_vertices)
    lay = build_app_layout(g, labels, cuda, ndev=ndev)
    halo = lay.exchange_plan(g, "halo")
    gen = np.random.default_rng(5 + bias)
    v, vl = lay.v_pad, lay.v_per_dev
    if combine == "sum":
        send, values = (gen.uniform(0, 1e-3, v).astype(np.float32)
                        for _ in range(2))
    else:
        send, values = (gen.integers(0, g.num_vertices, v).astype(np.int32)
                        for _ in range(2))
        send[gen.random(v) < 0.3] = ref.INF_I32
    send, values = torch.from_numpy(send).to(cuda), \
        torch.from_numpy(values).to(cuda)
    base = float(np.float32(0.15 / g.num_vertices))

    def same(a, b):
        if combine == "min" or a.dtype == torch.bool:
            return torch.equal(a, b)
        return torch.allclose(a, b, rtol=1e-5, atol=1e-9)

    kw = dict(combine=combine, bias=bias)
    ckw = dict(kw, update=update, damping=0.85)
    for rank in range(ndev):
        rows = slice(rank * vl, (rank + 1) * vl)
        for plan, lookup in ((None, send),
                             (halo, _halo_lookup(halo, send, rank, ndev,
                                                 vl))):
            sh = lay.shard(rank, plan)
            assert sh.frontier[1].numel() > 0
            partial = pregel_reduce(send[rows], *sh.interior, **kw)
            assert _bits_equal(partial, pregel_reduce(send[rows],
                                                      *sh.interior, **kw))
            assert same(partial, ref.pregel_reduce_ref(send[rows],
                                                       *sh.interior, **kw))
            args = (lookup, *sh.frontier, values[rows], sh.valid, base)
            got = pregel_combine(*args, acc_init=partial, **ckw)
            again = pregel_combine(*args, acc_init=partial, **ckw)
            assert all(_bits_equal(a, b) for a, b in zip(got, again))
            want = ref.pregel_combine_ref(*args, acc_init=partial, **ckw)
            assert all(same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("plan", ["allgather", "halo", "halo_delta",
                                  "delta"])
def test_run_app_on_one_rank_mesh_matches_single_device(cuda, plan):
    """A one-rank NCCL mesh: every workload under both schedules equals
    the run without a mesh, nothing crosses the wire, and each kernel
    launches once per superstep."""
    g = generators.watts_strogatz(3000, 10, 0.25, seed=7)
    labels = (np.arange(g.num_vertices) * 2654435761 % 8).astype(np.int32)
    mesh = make_partition_mesh(1)
    for workload in ("pagerank", "wcc", "bfs", "sssp"):
        want = run_app(g, labels, workload, device=cuda)
        for overlap in (True, False):
            pregel_reduce.launches = pregel_combine.launches = 0
            got = run_app(g, labels, workload, mesh=mesh, plan=plan,
                          overlap=overlap)
            assert pregel_reduce.launches == pregel_combine.launches \
                == got.supersteps == want.supersteps
            assert (got.plan, got.ndev, got.wire_bytes) == (plan, 1, 0.0)
            np.testing.assert_array_equal(got.values, want.values)
            np.testing.assert_array_equal(got.device_messages,
                                          want.device_messages)


def _delta_segment(g, dev, seed):
    """A merged delta segment over the padded upload of ``g``."""
    padded, _ = engine.padded_view(g, EngineOptions(device="cpu"))
    dd = delta.init_single_csr(padded.to_device(dev), g.num_directed_entries)
    gen = np.random.default_rng(seed)
    v = g.num_vertices
    out = delta.apply_delta(delta.DeltaTracker(g), dd, gen.integers(0, v, 40),
                            gen.integers(0, v, 40), engine.merge_delta)
    assert out is not None, "the batch overflowed the bucket's slack"
    return out[0]


@pytest.mark.parametrize("kind", ["random10", "sparse", "none", "all"])
@pytest.mark.parametrize("k", KS)
def test_frontier_kernel_bitwise(cuda, k, kind):
    """The frontier variant against its plain version, with and without a
    delta segment: bitwise on every row (inactive rows are the no-op
    proposal on both sides)."""
    g = generators.powerlaw_ba(400, 5, seed=2)
    dd = _delta_segment(g, cuda, seed=k)
    v = dd.deg_w.shape[0]
    gen = np.random.default_rng(11 * k)
    labels = torch.from_numpy(gen.integers(0, k, v).astype(np.int32)).to(cuda)
    pen = torch.from_numpy(gen.uniform(0.8, 1.2, k).astype(np.float32)
                           ).to(cuda)
    noise = rng.uniform(rng.PRNGKey(k), (v, k), 0.0, 1e-7, device=cuda)
    real = np.arange(v) < g.num_vertices
    act = {"random10": real & (gen.random(v) < 0.1),
           "sparse": real & (np.arange(v) % 97 == 5),
           "none": np.zeros(v, bool), "all": real}[kind]
    valid = torch.from_numpy(act).to(cuda)
    base = (dd.csr.row_ptr, dd.csr.dst, dd.csr.weight)
    for seg, plain_seg in (((), ()), ((dd.row_ptr, dd.dst, dd.w),
                                       (dd.src, dd.dst, dd.w))):
        for weighted in (True, False):
            n = fused_update_frontier.launches
            got = fused_update_frontier(labels, *base, dd.deg_w, pen, noise,
                                        valid, k, 1e-6, weighted, seg)
            assert fused_update_frontier.launches == n + 1
            want = ref.frontier_propose_ref(
                labels, dd.csr.src, dd.csr.dst, dd.csr.weight, dd.deg_w, pen,
                noise, valid, k, 1e-6, weighted, plain_seg)
            assert all(_bits_equal(a, b) for a, b in zip(got, want))
            # the base form folds the same segment
            got = fused_update(labels, *base, dd.deg_w, pen, noise,
                               g.num_vertices, k, 1e-6, weighted, seg)
            want = ref.fused_propose_ref(
                labels, dd.csr.src, dd.csr.dst, dd.csr.weight, dd.deg_w, pen,
                noise, g.num_vertices, k, 1e-6, weighted, plain_seg)
            assert all(_bits_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_session_frontier_adapt_on_card_matches_cpu(cuda, backend):
    """partition, a frontier fast adapt and a dense fast adapt on the card
    walk the CPU session's trajectory; the variant launches once per
    frontier iteration."""
    g = generators.watts_strogatz(3000, 10, 0.25, seed=7)
    cfg = SpinnerConfig(k=8, seed=3)
    gen = np.random.default_rng(0)
    b1 = (gen.integers(0, 3000, 40), gen.integers(0, 3000, 40))
    b2 = (gen.integers(0, 3000, 80), gen.integers(0, 3000, 80))
    runs = {}
    for dev in ("cpu", cuda):
        s = open_session(g, cfg, EngineOptions(engine="fused", device=dev,
                                               score_backend=backend))
        fused_update_frontier.launches = 0
        runs[str(dev)] = (s.partition(),
                          s.adapt(edge_updates=b1, frontier=True),
                          fused_update_frontier.launches,
                          s.adapt(edge_updates=b2), s.stats())
    want, got = runs["cpu"], runs[str(cuda)]
    launches, wst, gst = got[2], want[4], got[4]
    want, got = (want[0], want[1], want[3]), (got[0], got[1], got[3])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.loads, b.loads)
        assert (a.iterations, a.halted, a.scored_per_iter) == \
            (b.iterations, b.halted, b.scored_per_iter)
    assert launches == (got[1].iterations if backend == "cuda" else 0)
    assert gst["delta"] == wst["delta"]
    assert gst["delta"]["fast_adapts"] == 2
    assert gst["delta"]["host_rebuilds"] == 0 and gst["uploads"] == 1


@pytest.mark.parametrize("ndev", [2, 3])
@pytest.mark.parametrize("k", KS)
def test_seeded_kernel_bitwise(cuda, padded, ndev, k):
    """K1's overlap form on every shard of an ndev-way layout: the score
    kernel's interior partial, then the seeded kernel over the frontier
    against a global lookup -- bitwise equal to its plain version and to
    the base kernel over the whole shard (the last shard has pad rows)."""
    g, num_real = padded
    vl = -(-g.num_vertices // ndev)
    gen = np.random.default_rng(ndev * k)
    lookup = torch.from_numpy(
        gen.integers(0, k, vl * ndev).astype(np.int32)).to(cuda)
    pen = torch.from_numpy(gen.uniform(0.8, 1.2, k).astype(np.float32)
                           ).to(cuda)
    for rank in range(ndev):
        sh = distributed.rank_shard(g, ndev, rank, cuda)
        labels = lookup[sh.offset:sh.offset + vl].contiguous()
        noise = rng.uniform(rng.PRNGKey(k), (vl, k), 0.0, 1e-7, device=cuda)
        n_real = min(max(num_real - sh.offset, 0), vl)
        rp_i, src_i, d_i, w_i = sh.interior
        rp_f, src_f, d_f, w_f = sh.frontier
        partial = spinner_scores(labels, rp_i, d_i, w_i, k)
        assert _bits_equal(partial, ref.interior_partial_ref(labels, rp_i,
                                                             d_i, w_i, k))
        for weighted in (True, False):
            common = (sh.deg_w, pen, noise, n_real, k, 1e-6, weighted)
            n1 = fused_update_seeded.launches
            got = fused_update_seeded(labels, rp_f, d_f, w_f, *common,
                                      partial, lookup=lookup)
            assert fused_update_seeded.launches == n1 + 1
            plain = ref.fused_propose_ref(labels, src_f, d_f, w_f, *common,
                                          lookup=lookup, acc_init=partial)
            whole = fused_update(labels, sh.whole[0], sh.whole[2],
                                 sh.whole[3], *common, lookup=lookup)
            for a, b, c in zip(got, plain, whole):
                assert _bits_equal(a, b) and _bits_equal(a, c)


@pytest.mark.parametrize("plan", ["allgather", "halo", "halo_delta",
                                  "delta"])
@pytest.mark.parametrize("overlap", ["on", "off"])
def test_sharded_partition_on_card_matches_cpu(cuda, plan, overlap):
    """World size 1 on the card (a one-rank NCCL group) against the same
    run on the CPU, and against the card's fused run; K1's seeded form
    launches once per iteration under overlap."""
    g = generators.watts_strogatz(3000, 10, 0.25, seed=7)
    cfg = SpinnerConfig(k=8, seed=3, max_iters=60)
    kw = dict(label_exchange=plan, overlap=overlap)
    n_seeded = fused_update_seeded.launches
    card = partition(g, cfg, engine="sharded",
                     mesh=make_partition_mesh(1),
                     options=EngineOptions(**kw))
    if overlap == "on":
        assert fused_update_seeded.launches - n_seeded == card.iterations
    cpu = partition(g, cfg, engine="sharded",
                    mesh=make_partition_mesh(device="cpu"),
                    options=EngineOptions(device="cpu", **kw))
    fused = partition(g, cfg, engine="fused")
    for other in (cpu, fused):
        np.testing.assert_array_equal(card.labels, other.labels)
        np.testing.assert_array_equal(card.loads, other.loads)
        assert (card.iterations, card.halted) == (other.iterations,
                                                  other.halted)
    assert card.exchanged_bytes == 0.0


def _mesh_session(dev, plan: str, fused: str = "off",
                  backend: str = "torch"):
    g = generators.watts_strogatz(3000, 10, 0.25, seed=7)
    mesh = make_partition_mesh(1, device=None if dev != "cpu" else "cpu")
    return g, open_session(g, SpinnerConfig(k=8, seed=3), EngineOptions(
        device=dev, mesh=mesh, label_exchange=plan, overlap="off",
        fused_update=fused, score_backend=backend))


@pytest.mark.parametrize("plan", ["allgather", "halo", "halo_delta",
                                  "delta"])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_sharded_frontier_on_card_matches_cpu(cuda, plan, fused):
    """The sharded frontier runner on a one-rank NCCL group, from the
    converged labels with 5% of the vertices active, walks the CPU run's
    trajectory: labels, loads, iterations and scored counts (it runs to
    ``max_iters``: vertices that want to move but are throttled keep it
    from draining)."""
    g = generators.watts_strogatz(3000, 10, 0.25, seed=7)
    cfg = SpinnerConfig(k=8, seed=3, max_iters=40)
    base = partition(g, cfg, device="cpu").labels
    active = np.random.default_rng(2).random(3000) < 0.05
    runs = []
    for dev, mesh in ((cuda, make_partition_mesh(1)),
                      ("cpu", make_partition_mesh(device="cpu"))):
        opts = EngineOptions(device=dev, label_exchange=plan,
                             fused_update=fused, score_backend="torch")
        labels, loads, key = prepare_init(g, cfg, base, device=dev)
        state, scored = engine.run_sharded_frontier(
            g, cfg, labels, loads, key, active, mesh=mesh, opts=opts)
        runs.append((state, scored))
    (a, sa), (b, sb) = runs
    assert torch.equal(a.labels.cpu(), b.labels)
    assert torch.equal(a.loads.cpu(), b.loads)
    assert (int(a.iteration), bool(a.halted), sa) == (
        int(b.iteration), bool(b.halted), sb)


@pytest.mark.parametrize("plan", ["allgather", "delta", "halo_delta"])
def test_session_mesh_fast_path_on_card_matches_cpu(cuda, plan):
    """The session on a one-rank NCCL group: partition, a frontier adapt
    and a dense adapt equal the CPU mesh session's, with the same delta
    counters (fast for allgather and delta, the fallback for
    halo_delta)."""
    gen = np.random.default_rng(0)
    b1 = (gen.integers(0, 3000, 40), gen.integers(0, 3000, 40))
    b2 = (gen.integers(0, 3000, 80), gen.integers(0, 3000, 80))
    runs = {}
    for dev in (cuda, "cpu"):
        _, s = _mesh_session(dev, plan)
        runs[str(dev)] = (s.partition(),
                          s.adapt(edge_updates=b1, frontier=True),
                          s.adapt(edge_updates=b2), s.stats()["delta"])
    got, want = runs[str(cuda)], runs["cpu"]
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.loads, b.loads)
        assert (a.iterations, a.halted, a.scored_per_iter, a.engine) == (
            b.iterations, b.halted, b.scored_per_iter, b.engine)
    assert got[3] == want[3]
    assert got[3]["fast_adapts"] == (0 if plan == "halo_delta" else 2)


def test_cuda_backend_sharded_frontier_raises_on_card(cuda):
    _, s = _mesh_session(cuda, "allgather", backend="cuda")
    s.partition()
    with pytest.raises(ValueError, match="'torch' score backend"):
        s.adapt(edge_updates=([0], [9]), frontier=True)


def test_placement_on_card_matches_cpu(cuda):
    from repro_torch.core import placement
    card = placement.expert_placement_case(n_tokens=4000)
    cpu = placement.expert_placement_case(n_tokens=4000, device="cpu")
    np.testing.assert_array_equal(card[1], cpu[1])
    assert card[2] == cpu[2]
    costs = np.random.default_rng(3).random(40) + 0.5
    got = placement.place_pipeline_stages(costs, 4)
    want = placement.place_pipeline_stages(costs, 4, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


# ---- the row-group kernels (K3 and K1) on the shapes their design must
# handle: a hub longer than a batch or a group's edges, runs of empty
# rows (whole groups empty), V not a multiple of the group size, V = 1,
# and enough rows that each warp walks several groups.

def _csr_case(name, gen):
    """``(row_ptr, dst, w)`` numpy arrays of a small CSR over its own rows
    (dst < V); weights 1 or 2 with some weight-0 pad entries."""
    if name == "star":                # hub rows of 1,500 and 200 entries
        v = 300
        lens = np.ones(v, np.int64)
        lens[5], lens[40] = 1500, 200
    elif name == "empty_runs":        # 40 empty rows, then scattered ones
        v = 200
        lens = gen.integers(0, 40, v)
        lens[:40] = 0
        lens[gen.random(v) < 0.3] = 0
    elif name == "ragged":            # V a multiple of no group size
        v = 97
        lens = gen.integers(0, 40, v)
    elif name == "many_groups":       # several groups a warp: more rows
        v = 600_001                   # than one sweep of the grid holds
        lens = gen.integers(0, 6, v)
    else:                             # "single": V = 1
        v = 1
        lens = np.array([3])
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    e = int(row_ptr[-1])
    dst = gen.integers(0, v, e).astype(np.int32)
    w = gen.choice(np.array([0.0, 1.0, 2.0], np.float32), e,
                   p=[0.1, 0.6, 0.3])
    return row_ptr, dst, w


CASES = ["star", "empty_runs", "ragged", "single", "many_groups"]


@pytest.mark.parametrize("combine,bias", [("sum", 0), ("min", 1)])
@pytest.mark.parametrize("case", CASES + ["unaligned"])
def test_reduce_groups_match_plain(cuda, case, combine, bias):
    """K3 on each shape, with and without a seed: min bitwise equal to the
    plain version, sum within rtol 1e-5 and bitwise equal to itself over
    three launches.  "unaligned" reads dst from an offset of one entry, so
    no 16-byte load lines up."""
    gen = np.random.default_rng(len(case) + bias)
    rp, dst, _ = _csr_case("star" if case == "unaligned" else case, gen)
    v = rp.size - 1
    if case == "unaligned":
        dst = np.concatenate([[0], dst]).astype(np.int32)
    dst_t = torch.from_numpy(dst).to(cuda)
    if case == "unaligned":
        dst_t = dst_t[1:]
    rp_t = torch.from_numpy(rp).to(cuda)
    if combine == "sum":
        send, init = (torch.from_numpy(gen.uniform(0, 1e-3, v).astype(
            np.float32)).to(cuda) for _ in range(2))
    else:
        send, init = (torch.from_numpy(gen.integers(0, v, v).astype(
            np.int32)).to(cuda) for _ in range(2))
        send[::3] = ref.INF_I32
    for seed in (None, init):
        kw = dict(combine=combine, bias=bias, acc_init=seed)
        n = pregel_reduce.launches
        got = [pregel_reduce(send, rp_t, dst_t, **kw) for _ in range(3)]
        assert pregel_reduce.launches == n + 3
        want = ref.pregel_reduce_ref(send, rp_t, dst_t, **kw)
        assert all(_bits_equal(got[0], x) for x in got[1:])
        if combine == "min":
            assert _bits_equal(got[0], want)
        else:
            assert torch.allclose(got[0], want, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("labels_kind", ["random", "converged"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_fused_groups_match_plain(cuda, k, case, labels_kind):
    """K1's three forms on each shape against their plain versions, bit
    for bit: the base form with and without a delta segment, the frontier
    form under a mask with whole groups inactive and a group with exactly
    one active row (and the delta segment), the seeded form from an
    integer partial.  "converged" puts nearly every neighbour on one label,
    where all 32 lanes of a batch share a (row, label) key."""
    gen = np.random.default_rng(k + len(case))
    rp, dst, w = _csr_case(case, gen)
    v = rp.size - 1
    d_rp, d_dst, d_w = _csr_case(case, np.random.default_rng(k))
    d_dst %= v
    if labels_kind == "random":
        lookup = gen.integers(0, k, v).astype(np.int32)
    else:
        lookup = np.where(gen.random(v) < 0.01, gen.integers(0, k, v),
                          k // 2).astype(np.int32)
    up = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda))
    labels, rp_t, dst_t, w_t = up(lookup), up(rp), up(dst), up(w)
    src_t = ref.csr_src(rp_t)
    deg_w = torch.zeros(v, dtype=torch.float32, device=cuda).index_add_(
        0, src_t.long(), w_t)
    pen = gen.uniform(0.8, 1.2, k).astype(np.float32)
    pen[0] = 0.0                          # an empty part: +0 - 0 stays +0
    pen = up(pen)
    noise = rng.uniform(rng.PRNGKey(k), (v, k), 0.0, 1e-7, device=cuda)
    seg = (up(d_rp), up(d_dst), up(d_w))
    plain_seg = (ref.csr_src(seg[0]), seg[1], seg[2])
    num_real = max(v - 3, 0)
    act = gen.random(v) < 0.1
    act[:32] = False                      # whole groups inactive
    act[32:64] = False
    act[33:34] = True                     # ... and one with one active row
    act[64:96] = True
    valid = up(act)
    acc_init = up(gen.integers(0, 4, (v, k)).astype(np.float32))
    for weighted in (True, False):
        common = (deg_w, pen, noise)
        tail = (k, 1e-6, weighted)
        for s, ps in (((), ()), (seg, plain_seg)):
            got = fused_update(labels, rp_t, dst_t, w_t, *common, num_real,
                               *tail, s)
            want = ref.fused_propose_ref(labels, src_t, dst_t, w_t, *common,
                                         num_real, *tail, ps)
            assert all(_bits_equal(a, b) for a, b in zip(got, want))
            got = fused_update_frontier(labels, rp_t, dst_t, w_t, *common,
                                        valid, *tail, s)
            want = ref.frontier_propose_ref(labels, src_t, dst_t, w_t,
                                            *common, valid, *tail, ps)
            assert all(_bits_equal(a, b) for a, b in zip(got, want))
        got = fused_update_seeded(labels, rp_t, dst_t, w_t, *common,
                                  num_real, *tail, acc_init)
        want = ref.fused_propose_ref(labels, src_t, dst_t, w_t, *common,
                                     num_real, *tail, acc_init=acc_init)
        assert all(_bits_equal(a, b) for a, b in zip(got, want))


# ---- K2 as a row-group kernel, K4 on K3's row groups, and K1 and K2 on
# weights that are not integers.

def _labels_of(kind, gen, n, k):
    """Uniform labels, or "converged" ones: nearly all on one label."""
    if kind == "random":
        return gen.integers(0, k, n).astype(np.int32)
    return np.where(gen.random(n) < 0.01, gen.integers(0, k, n),
                    k // 2).astype(np.int32)


K2_MAX_K = 58043     # the largest k scores_layout takes: one row, one warp
# every shape at every k, but the 600,001-row case not at the largest k
# (its (V, k) f32 output alone would be 139 GB)
K2_CASES = [(k, case) for k in KS + [K2_MAX_K] for case in CASES
            if (k, case) != (K2_MAX_K, "many_groups")]


def test_scores_layout_limit(cuda):
    """The largest k launches (one warp of one row, every byte of a
    block's shared memory) and the next one is refused by the wrapper."""
    assert scores_layout(K2_MAX_K)[:2] == (1, 1)
    with pytest.raises(ValueError):
        scores_layout(K2_MAX_K + 1)


@pytest.mark.parametrize("labels_kind", ["random", "converged"])
@pytest.mark.parametrize("k,case", K2_CASES)
def test_score_groups_match_plain(cuda, k, case, labels_kind):
    """K2 on each shape against the scatter-add, bit for bit: over the
    rows' own labels (the overlap's interior half), over a lookup three
    times longer that dst indexes (the frontier half on a shard), and both
    halves through ``CudaCsrBackend.make_sharded_scores_split``."""
    gen = np.random.default_rng(k + len(case))
    rp, dst, w = _csr_case(case, gen)
    v = rp.size - 1
    up = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda))
    labels = up(_labels_of(labels_kind, gen, v, k))
    lookup = up(_labels_of(labels_kind, gen, 3 * v, k))
    rp_t, dst_t, w_t = up(rp), up(dst), up(w)
    dst_f = up(gen.integers(0, 3 * v, dst.size).astype(np.int32))
    src = ref.csr_src(rp_t)
    n = spinner_scores.launches
    part = spinner_scores(labels, rp_t, dst_t, w_t, k)
    want_part = ref.spinner_scores_ref(labels, src, dst_t, w_t, v, k)
    assert _bits_equal(part, want_part)
    front = spinner_scores(labels, rp_t, dst_f, w_t, k, lookup=lookup)
    assert _bits_equal(front, ref.spinner_scores_ref(lookup, src, dst_f, w_t,
                                                     v, k))
    assert spinner_scores.launches == n + 2
    interior, frontier = CudaCsrBackend().make_sharded_scores_split(k, v)
    bind = types.SimpleNamespace(score=(rp_t, dst_t, w_t, rp_t, dst_f, w_t))
    got = frontier(interior(labels, bind), lookup, labels, bind)
    assert _bits_equal(got, ref.spinner_scores_ref(lookup, src, dst_f, w_t,
                                                   v, k, init=want_part))


@pytest.mark.parametrize("combine,update,bias", PREGEL)
@pytest.mark.parametrize("case", CASES)
def test_combine_groups_match_plain(cuda, case, combine, update, bias):
    """K4 on each shape over the full CSR and over an empty frontier, with
    and without a seed, ``valid`` False on ~30% of the rows: min bitwise
    equal to the plain version, sum within rtol 1e-5, atol 1e-9, and every
    output bitwise equal to itself over three launches."""
    gen = np.random.default_rng(len(case) + 3 * bias)
    rp, dst, _ = _csr_case(case, gen)
    v = rp.size - 1
    up = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda))
    if combine == "sum":
        send, values, init = (up(gen.uniform(0, 1e-3, v).astype(np.float32))
                              for _ in range(3))
    else:
        send, values, init = (up(gen.integers(0, v, v).astype(np.int32))
                              for _ in range(3))
        send[::3] = ref.INF_I32
        values[1::4] = ref.INF_I32
    valid = up(gen.random(v) >= 0.3)
    base = float(np.float32(0.15 / v))
    empty = (torch.zeros(v + 1, dtype=torch.int64, device=cuda),
             torch.zeros(0, dtype=torch.int32, device=cuda))
    for (rp_t, dst_t), seed in ((c, s) for c in ((up(rp), up(dst)), empty)
                                for s in (None, init)):
        kw = dict(combine=combine, update=update, damping=0.85, bias=bias,
                  acc_init=seed)
        n = pregel_combine.launches
        got = [pregel_combine(send, rp_t, dst_t, values, valid, base, **kw)
               for _ in range(3)]
        assert pregel_combine.launches == n + 3
        for again in got[1:]:
            assert all(_bits_equal(a, b) for a, b in zip(got[0], again))
        want = ref.pregel_combine_ref(send, rp_t, dst_t, values, valid, base,
                                      **kw)
        for a, b in zip(got[0], want):
            if combine == "min" or a.dtype == torch.bool:
                assert _bits_equal(a, b)
            else:
                assert torch.allclose(a, b, rtol=1e-5, atol=1e-9)


def _scaled_graph(n, scale):
    """``watts_strogatz(n, ...)`` with its Eq. 3 weights times ``scale``
    (through ``_finish``, as a caller may build it), on its padded layout
    (weight-0 pad entries included)."""
    ws = (generators.watts_strogatz(600, 8, 0.2, seed=3) if n == 600 else
          generators.watts_strogatz(n, 16, 0.3, seed=1))
    g = _finish(ws.src, ws.dst, np.float32(scale) * ws.weight, n)
    return engine.padded_view(g, EngineOptions(device="cpu"))


def _hold_float(got, want, x, valid, labels, deg, dyadic, weighted):
    """K1's outputs against the plain version's.  Weights that are
    multiples of 0.5 sum exactly in any order: every output bitwise equal.
    Other weights round in the kernel's order: ``best`` equal wherever the
    plain version's top two of ``x = total + noise + bonus`` differ by more
    than 1e-5 relative; ``tot_best`` / ``tot_cur`` within rtol 1e-6 and
    atol 1e-6 (a total is s / deg - pen, a difference of terms of order 1,
    so its error is relative to those terms) where ``best`` agrees; M(l)
    within rtol 1e-6 of a float64 sum over the kernel's own proposals (the
    plain version's own float32 sum of ~3,000 masses a label strays
    1.6e-6 from it, so it is no yardstick at that tolerance)."""
    if dyadic:
        assert all(_bits_equal(a, b) for a, b in zip(got, want))
        return
    top = x.topk(2, dim=1).values
    clear = (top[:, 0] - top[:, 1]) > 1e-5 * top[:, 0].abs()
    assert int(clear.sum()) > 0.5 * clear.numel()
    assert torch.equal(got[0][clear], want[0][clear])
    same = got[0] == want[0]
    for a, b in zip(got[1:3], want[1:3]):
        assert torch.allclose(a[same], b[same], rtol=1e-6, atol=1e-6)
    moving = (got[0] != labels) & valid
    mass = (deg if weighted else torch.ones_like(deg)).double()
    m64 = torch.zeros(got[3].numel(), dtype=torch.float64,
                      device=deg.device).index_add_(
        0, got[0].long(), torch.where(moving, mass, 0.0))
    assert torch.allclose(got[3].double(), m64, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("scale", [0.5, 0.3])
@pytest.mark.parametrize("n", [600, 20_000])
def test_float_weights_match_plain(cuda, n, scale):
    """K1's three forms and K2 sum the weights they are given: on the
    halved Eq. 3 weights (0.5 and 1) bitwise equal to their plain
    versions, on weights times 0.3 within the tolerances of
    ``_hold_float``; K2 bitwise on 0.5, within rtol 1e-6 on 0.3."""
    g, num_real = _scaled_graph(n, scale)
    csr = g.to_device(cuda)
    v, k = g.num_vertices, 6
    dyadic = scale == 0.5
    gen = np.random.default_rng(n)
    labels = torch.from_numpy(gen.integers(0, k, v).astype(np.int32)
                              ).to(cuda)
    loads = torch.zeros(k, device=cuda).index_add_(0, labels.long(),
                                                   csr.deg_w)
    pen = loads / torch.tensor(1.05 * g.total_weight / k, device=cuda)
    noise = rng.uniform(rng.PRNGKey(n), (v, k), 0.0, 1e-7, device=cuda)
    bonus = torch.nn.functional.one_hot(labels.long(), k).to(
        torch.float32) * float(np.float32(1e-6))
    real = torch.arange(v, device=cuda) < num_real
    act = real & torch.from_numpy(gen.random(v) < 0.3).to(cuda)
    base = (csr.row_ptr, csr.dst, csr.weight)

    def x_of(scores):
        total = scores / torch.clamp(csr.deg_w, min=1.0)[:, None] - pen
        return total + noise + bonus

    scores = spinner_scores(labels, *base, k)
    plain_scores = ref.spinner_scores_ref(labels, csr.src, csr.dst,
                                          csr.weight, v, k)
    if dyadic:
        assert _bits_equal(scores, plain_scores)
    else:
        assert torch.allclose(scores, plain_scores, rtol=1e-6, atol=0.0)
    x = x_of(plain_scores)
    for weighted in (True, False):
        tail = (k, 1e-6, weighted)
        got = fused_update(labels, *base, csr.deg_w, pen, noise, num_real,
                           *tail)
        want = ref.fused_propose_ref(labels, csr.src, csr.dst, csr.weight,
                                     csr.deg_w, pen, noise, num_real, *tail)
        _hold_float(got, want, x, real, labels, csr.deg_w, dyadic, weighted)
        got = fused_update_frontier(labels, *base, csr.deg_w, pen, noise,
                                    act, *tail)
        want = ref.frontier_propose_ref(labels, csr.src, csr.dst, csr.weight,
                                        csr.deg_w, pen, noise, act, *tail)
        _hold_float(got, want, x, act, labels, csr.deg_w, dyadic, weighted)
        for rank in range(2):   # the overlap form on a 2-way layout
            sh = distributed.rank_shard(g, 2, rank, cuda)
            vl, off = sh.v_local, sh.offset
            lab = labels[off:off + vl].contiguous()
            rp_i, _, d_i, w_i = sh.interior
            rp_f, src_f, d_f, w_f = sh.frontier
            partial = spinner_scores(lab, rp_i, d_i, w_i, k)
            common = (sh.deg_w, pen, noise[off:off + vl].contiguous(),
                      min(max(num_real - off, 0), vl), *tail)
            got = fused_update_seeded(lab, rp_f, d_f, w_f, *common, partial,
                                      lookup=labels)
            want = ref.fused_propose_ref(lab, src_f, d_f, w_f, *common,
                                         lookup=labels, acc_init=partial)
            _hold_float(got, want, x[off:off + vl], real[off:off + vl], lab,
                        sh.deg_w, dyadic, weighted)


# ---- the autotuner's tiles: every candidate against the plain versions

def _tiles(k):
    """Every tile the autotuner may bind at k (either kernel's
    candidates), and the smallest, one warp of one row."""
    return sorted(set(autotune.candidates(k, "fused")
                      + autotune.candidates(k, "scores") + [(1, 1)]))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
def test_candidate_tiles_match_plain(cuda, k, case):
    """Each tile, cut to each form as the backend cuts it (``clip_tile``),
    gives K2 and K1's three forms bit for bit the plain versions' outputs
    on the Eq. 3 weights (and weight-0 pads), each launch at that tile."""
    gen = np.random.default_rng(3 * k + len(case))
    rp, dst, w = _csr_case(case, gen)
    v = rp.size - 1
    up = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda))
    labels = up(_labels_of("random", gen, v, k))
    rp_t, dst_t, w_t = up(rp), up(dst), up(w)
    src_t = ref.csr_src(rp_t)
    deg_w = torch.zeros(v, dtype=torch.float32, device=cuda).index_add_(
        0, src_t.long(), w_t)
    pen = up(gen.uniform(0.8, 1.2, k).astype(np.float32))
    noise = rng.uniform(rng.PRNGKey(k), (v, k), 0.0, 1e-7, device=cuda)
    valid = up(gen.random(v) < 0.3)
    acc_init = up(gen.integers(0, 4, (v, k)).astype(np.float32))
    common = (deg_w, pen, noise)
    tail = (k, 1e-6, True)
    num_real = max(v - 3, 0)
    want = {
        "scores": ref.spinner_scores_ref(labels, src_t, dst_t, w_t, v, k),
        "fused": ref.fused_propose_ref(labels, src_t, dst_t, w_t, *common,
                                       num_real, *tail),
        "frontier": ref.frontier_propose_ref(labels, src_t, dst_t, w_t,
                                             *common, valid, *tail),
        "seeded": ref.fused_propose_ref(labels, src_t, dst_t, w_t, *common,
                                        num_real, *tail, acc_init=acc_init)}
    base = (labels, rp_t, dst_t, w_t)
    for tile in _tiles(k):
        t = {form: clip_tile(k, form, tile) for form in want}
        got = {
            "scores": spinner_scores(*base, k, tile=t["scores"]),
            "fused": fused_update(*base, *common, num_real, *tail,
                                  tile=t["fused"]),
            "frontier": fused_update_frontier(*base, *common, valid, *tail,
                                              tile=t["frontier"]),
            "seeded": fused_update_seeded(*base, *common, num_real, *tail,
                                          acc_init, tile=t["seeded"])}
        assert fused_update_seeded.last_tile[:2] == t["seeded"]
        assert spinner_scores.last_tile[:2] == t["scores"]
        assert _bits_equal(got["scores"], want["scores"]), tile
        for form in ("fused", "frontier", "seeded"):
            assert all(_bits_equal(a, b)
                       for a, b in zip(got[form], want[form])), (tile, form)


@pytest.mark.parametrize("scale", [0.5, 0.3])
def test_candidate_tiles_on_float_weights(cuda, scale):
    """``test_float_weights_match_plain``'s claims hold at every tile: on
    halved weights bitwise equal to the plain versions, on weights times
    0.3 within ``_hold_float``'s tolerances (K2 within rtol 1e-6) -- a
    tile changes where the fold's batches cut a row, so such sums round
    in another order than the default tile's."""
    g, num_real = _scaled_graph(20_000, scale)
    csr = g.to_device(cuda)
    v, k = g.num_vertices, 6
    dyadic = scale == 0.5
    gen = np.random.default_rng(7)
    labels = torch.from_numpy(gen.integers(0, k, v).astype(np.int32)
                              ).to(cuda)
    loads = torch.zeros(k, device=cuda).index_add_(0, labels.long(),
                                                   csr.deg_w)
    pen = loads / torch.tensor(1.05 * g.total_weight / k, device=cuda)
    noise = rng.uniform(rng.PRNGKey(7), (v, k), 0.0, 1e-7, device=cuda)
    bonus = torch.nn.functional.one_hot(labels.long(), k).to(
        torch.float32) * float(np.float32(1e-6))
    real = torch.arange(v, device=cuda) < num_real
    base = (csr.row_ptr, csr.dst, csr.weight)
    plain_scores = ref.spinner_scores_ref(labels, csr.src, csr.dst,
                                          csr.weight, v, k)
    x = (plain_scores / torch.clamp(csr.deg_w, min=1.0)[:, None] - pen
         + noise + bonus)
    want = ref.fused_propose_ref(labels, csr.src, csr.dst, csr.weight,
                                 csr.deg_w, pen, noise, num_real, k, 1e-6,
                                 True)
    for tile in _tiles(k):
        scores = spinner_scores(labels, *base, k,
                                tile=clip_tile(k, "scores", tile))
        if dyadic:
            assert _bits_equal(scores, plain_scores), tile
        else:
            assert torch.allclose(scores, plain_scores, rtol=1e-6, atol=0.0)
        got = fused_update(labels, *base, csr.deg_w, pen, noise, num_real,
                           k, 1e-6, True, tile=clip_tile(k, "fused", tile))
        _hold_float(got, want, x, real, labels, csr.deg_w, dyadic, True)


@pytest.mark.parametrize("k", [2, 32, 130, 512])
def test_tile_grid_matches_model(cuda, k):
    """The autotuner's schedule has the grid the card's occupancy query
    gives every candidate (``csr::grid_for``), for both kernels."""
    deg = np.full(2_000_000, 16)
    for kernel in autotune.KERNELS:
        for warps, rows in autotune.candidates(k, kernel):
            model = autotune.slot_features(deg, warps, rows, k, kernel)
            assert tile_grid(kernel, deg.size, k, (warps, rows)) \
                == model["grid"], (kernel, warps, rows)


def test_partition_under_autotune_on_card_matches_cpu(cuda):
    """``partition`` on the card under every autotune mode, and at two
    pinned tiles, equals the CPU run label for label; the tile the run
    launched is the one the options resolve to."""
    g = generators.powerlaw_ba(3000, 6, seed=9)
    cfg = SpinnerConfig(k=8, seed=3)
    want = partition(g, cfg, engine="fused", record_history=False,
                     device="cpu")
    for kw in (dict(autotune="off"), dict(autotune="on"), dict(),
               dict(score_backend=CudaCsrBackend(warps=4, rows=8)),
               dict(score_backend=CudaCsrBackend(warps=16, rows=1),
                    fused_update="off")):
        opts = EngineOptions(device=cuda, **kw)
        got = partition(g, cfg, engine="fused", record_history=False,
                        options=opts)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.loads, want.loads)
        assert (got.iterations, got.halted) == (want.iterations, want.halted)
        tuned = engine._autotuned(g, cfg, opts)
        tile = engine.tile_config(tuned, cfg.k)
        last = (fused_update if tuned.resolved_fused_update() == "on"
                else spinner_scores).last_tile
        assert last == (tile["warps"], tile["rows"], tile["smem_bytes"])


def test_halved_weights_partition_matches_cpu(cuda):
    """``partition`` on the halved weights of ``watts_strogatz(600, 8,
    0.2, seed=3)`` at k = 6 (the graph the CPU tests hold to the
    reference): the card's fused kernel, split kernel and scatter runs
    equal the CPU run label for label."""
    ws = generators.watts_strogatz(600, 8, 0.2, seed=3)
    g = _finish(ws.src, ws.dst, 0.5 * ws.weight, 600)
    cfg = SpinnerConfig(k=6, seed=3)
    want = partition(g, cfg, engine="fused", record_history=False,
                     device="cpu")
    for backend, fused in (("cuda", "on"), ("cuda", "off"),
                           ("torch", "off")):
        fused_update.launches = spinner_scores.launches = 0
        got = partition(g, cfg, engine="fused", record_history=False,
                        options=EngineOptions(device=cuda,
                                              score_backend=backend,
                                              fused_update=fused))
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.loads, want.loads)
        assert (got.iterations, got.halted) == (want.iterations, want.halted)
        if backend == "cuda":
            assert fused_update.launches + spinner_scores.launches \
                == got.iterations


# ---------------------------------------------------------------------------
# the serving tier and durability on the card (chip_smoke.py phase (k), small)
# ---------------------------------------------------------------------------

def _serve_rounds(opts, batch_min, graphs, batches, cfg):
    """Every round sends each tenant its bursts; returns the tickets'
    results per round, the batched runs a round, the scheduler's stats
    (marked after the first round) and the K1 launches of the rounds."""
    from repro_torch.serve import PartitionScheduler
    sched = PartitionScheduler(batch_min=batch_min, policies=())
    for i, g in enumerate(graphs):
        sched.add_tenant(f"t{i}", g, cfg, opts, partition=True)
    launches = fused_update.launches
    results, batched = [], []
    for rnd, per_tenant in enumerate(batches):
        if rnd == 1:
            sched.mark()
        before = sched.stats()["batched_dispatches"]
        tks = [[sched.submit(f"t{i}", "edge_updates", edge_updates=b)
                for b in bursts] for i, bursts in enumerate(per_tenant)]
        sched.drain()
        batched.append(sched.stats()["batched_dispatches"] - before)
        results.append([t[-1].result for t in tks])
    sessions = [t.session for t in sched.tenants.values()]
    return (results, batched, sched.stats(), sessions,
            fused_update.launches - launches)


def test_serving_fleet_on_card_matches_serial(cuda):
    """Three tenants of ~20,000 vertices in one bucket, two rounds of three
    400-pair bursts each: the torch backend batched (one batched run a
    round) and serial, and the CUDA backend through the scheduler
    (serial, K1 once an iteration), all equal to a twin session that
    adapts once per coalesced window; no upload and no host rebuild
    after the warm round."""
    from repro_torch.core import delta as delta_mod
    from repro_torch.serve import traffic
    cfg = SpinnerConfig(k=32)
    graphs = [traffic.tenant_graph(20_000 + 17 * i, seed=i, k_nbrs=16)
              for i in range(3)]
    assert len({engine.graph_buckets(g) for g in graphs}) == 1
    rng_np = np.random.default_rng(5)
    batches = [[[traffic.random_edge_updates(g.num_vertices, 400, rng_np)
                 for _ in range(3)] for g in graphs] for _ in range(2)]
    torch_opts = EngineOptions(device=cuda, score_backend="torch")
    cuda_opts = EngineOptions(device=cuda, score_backend="cuda")
    batched, nb, st, sess, k1 = _serve_rounds(torch_opts, 2, graphs,
                                              batches, cfg)
    assert nb == [1, 1] and st["errors"] == 0 and k1 == 0
    assert st["uploads_since_mark"] == 0
    assert all(s.stats()["delta"]["host_rebuilds"] == 0 for s in sess)
    serial, nb, st, _, _ = _serve_rounds(torch_opts, 10 ** 9, graphs,
                                         batches, cfg)
    assert nb == [0, 0] and st["errors"] == 0
    kernel, _, st, _, k1 = _serve_rounds(cuda_opts, 2, graphs, batches, cfg)
    assert st["errors"] == 0 and st["batched_dispatches"] == 0
    assert k1 == sum(r.iterations for rnd in kernel for r in rnd)
    for i, g in enumerate(graphs):
        twin = open_session(g, cfg, torch_opts)
        twin.partition(record_history=False)
        for rnd in range(2):
            want = twin.adapt(edge_updates=delta_mod.coalesce_updates(
                batches[rnd][i]), record_history=False)
            for got in (batched[rnd][i], serial[rnd][i], kernel[rnd][i]):
                np.testing.assert_array_equal(got.labels, want.labels)
                np.testing.assert_array_equal(got.loads, want.loads)
                assert (got.iterations, got.halted) == (want.iterations,
                                                        want.halted)


def test_uniform_many_on_card(cuda):
    keys = [rng.split(rng.PRNGKey(s))[0] for s in range(5)]
    many = rng.uniform_many(keys, (1000, 32), 0.0, 1e-6, device=cuda)
    for b, key in enumerate(keys):
        assert _bits_equal(many[b], rng.uniform(key, (1000, 32), 0.0, 1e-6,
                                                device=cuda))


# The threefry kernel (``kernels/threefry.py``) against rng's plain int64
# path on the card, bit for bit: the float32 values and their int32 view.
# Counter offsets: none, a row start of a (4 M, 32) draw, and a range
# that crosses 2**32.
THREEFRY_OFFSETS = [0, 3_000_001 * 32, 2**32 - 17]
THREEFRY_BOUNDS = [(0.0, 1.0), (0.0, 1e-7), (-2.0, 3.0)]


def _same_bits(a, b):
    return torch.equal(a, b) and torch.equal(a.view(torch.int32),
                                             b.view(torch.int32))


def test_threefry_full_size_draws(cuda):
    """One iteration's draws at the benchmark's size: the (4,194,304, 32)
    tie noise and the (4,194,304,) migration draws, a launch each."""
    k_noise, k_mig = rng.split(rng.split(rng.PRNGKey(2**31 + 3))[1])
    v = 4_194_304
    n0 = threefry.uniform_threefry.launches
    noise = rng.uniform(k_noise, (v, 32), 0.0, 1e-7, device=cuda)
    u = rng.uniform(k_mig, (v,), device=cuda)
    assert threefry.uniform_threefry.launches == n0 + 2
    assert _same_bits(noise, rng._uniform_plain(k_noise, (v, 32), 0.0, 1e-7,
                                                device=cuda))
    assert _same_bits(u, rng._uniform_plain(k_mig, (v,), device=cuda))


@pytest.mark.parametrize("bounds", THREEFRY_BOUNDS)
@pytest.mark.parametrize("offset", THREEFRY_OFFSETS)
@pytest.mark.parametrize("n", [1, 31, 2**24 + 3])
def test_threefry_uniform_matches_plain(cuda, n, offset, bounds):
    key = rng.split(rng.PRNGKey(n + offset))[0]
    n0 = threefry.uniform_threefry.launches
    got = rng.uniform(key, (n,), *bounds, device=cuda, offset=offset)
    assert threefry.uniform_threefry.launches == n0 + 1
    want = rng._uniform_plain(key, (n,), *bounds, device=cuda, offset=offset)
    assert _same_bits(got, want)
    if n < 100:
        assert _same_bits(got.cpu(), rng.uniform(key, (n,), *bounds,
                                                 device="cpu", offset=offset))


@pytest.mark.parametrize("bounds", THREEFRY_BOUNDS)
@pytest.mark.parametrize("nb", [1, 3, 16])
def test_threefry_uniform_many_matches_plain(cuda, nb, bounds):
    """Keys as a list and as the strided ``keys[:, 0]`` view that
    ``engine.batched_draws`` passes; ragged rows (n % 4 = 3) put every row
    but the first off the 16-byte boundary."""
    keys = [rng.split(rng.PRNGKey(1000 + b)) for b in range(nb)]
    words = torch.tensor(keys, dtype=torch.int64, device=cuda)   # (nb, 2, 2)
    shape = (1001, 7)
    want = rng._uniform_many_plain([k[0] for k in keys], shape, *bounds,
                                   device=cuda)
    for given in ([k[0] for k in keys], words[:, 0]):
        n0 = threefry.uniform_threefry.launches
        got = rng.uniform_many(given, shape, *bounds, device=cuda)
        assert threefry.uniform_threefry.launches == n0 + 1
        assert got.shape == (nb,) + shape and _same_bits(got, want)
    for b in range(nb):
        assert _same_bits(want[b], rng._uniform_plain(keys[b][0], shape,
                                                      *bounds, device=cuda))


def test_threefry_wrapper_rejects_bad_inputs(cuda):
    """A CPU device, keys that are not int64, keys of the wrong shape or
    keys on another device raise and launch nothing; the output is always
    a new tensor."""
    n0 = threefry.uniform_threefry.launches
    words = torch.tensor([rng.PRNGKey(3)], dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        threefry.uniform_threefry(rng.PRNGKey(3), 64, 0.0, 1.0, device="cpu")
    bad = [(TypeError, words.to(torch.int32)),
           (ValueError, words[:, :1]),
           (ValueError, words[0]),
           (ValueError, words.cpu())]
    for error, keys in bad:
        with pytest.raises(error):
            threefry.uniform_threefry(keys, 64, 0.0, 1.0, device=cuda)
    assert threefry.uniform_threefry.launches == n0
    a = threefry.uniform_threefry(words, 64, 0.0, 1.0, device=cuda)
    b = threefry.uniform_threefry(words, 64, 0.0, 1.0, device=cuda)
    assert threefry.uniform_threefry.launches == n0 + 2
    assert a.data_ptr() != b.data_ptr() and a.is_contiguous()
    assert _same_bits(a[0], rng._uniform_plain(rng.PRNGKey(3), (64,),
                                               device=cuda))


def test_checkpointed_session_continues_on_card(cuda, tmp_path):
    """export_state, checkpoint.save, restore, import_state into a fresh
    session on the card: the next adapt equals the uninterrupted one."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.serve import traffic
    cfg = SpinnerConfig(k=32)
    g = traffic.tenant_graph(20_000, seed=0, k_nbrs=16)
    gen = np.random.default_rng(3)
    b1, b2 = (traffic.random_edge_updates(g.num_vertices, 400, gen)
              for _ in range(2))
    opts = EngineOptions(device=cuda, score_backend="cuda")
    live = open_session(g, cfg, opts)
    live.partition(record_history=False)
    live.adapt(edge_updates=b1, record_history=False)
    g_b1 = live.graph
    checkpoint.save(str(tmp_path), 1, live.export_state())
    want = live.adapt(edge_updates=b2, record_history=False)
    snap = checkpoint.restore(str(tmp_path), live.export_state())
    fresh = open_session(g_b1, cfg, opts).import_state(snap)
    got = fresh.adapt(edge_updates=b2, record_history=False)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.loads, want.loads)
    assert (got.iterations, got.halted) == (want.iterations, want.halted)


def test_process_cluster_on_card_matches_cpu(cuda, tmp_path):
    """Two worker processes on one card lose worker 1 at iteration 6; the
    recovered labels equal an uninterrupted one-process CPU run, and each
    worker launched K2 once a superstep."""
    import json
    import os

    from repro_torch.cluster import (ProcessClusterConfig,
                                     ProcessClusterSupervisor,
                                     write_edge_shards)
    g = generators.watts_strogatz(20_000, 10, 0.3, seed=4)
    shards = str(tmp_path / "shards")
    write_edge_shards(g, shards, num_hosts=2)
    job = {"shard_dir": shards, "k": 8, "seed": 2, "max_iters": 16,
           "snapshot_every": 4, "rpc_timeout": 120}
    wd = str(tmp_path / "card")
    out = ProcessClusterSupervisor(
        ProcessClusterConfig(workdir=wd, num_processes=2),
        {**job, "device": "cuda",
         "fault": {"gen": 0, "pid": 1, "iteration": 6}}).run()
    assert out["restarts"] == 1 and out["result"]["world"] == 1
    ProcessClusterSupervisor(
        ProcessClusterConfig(workdir=str(tmp_path / "cpu"), num_processes=1),
        {**job, "device": "cpu"}).run()
    np.testing.assert_array_equal(
        np.load(os.path.join(wd, "labels.npy")),
        np.load(str(tmp_path / "cpu" / "labels.npy")))
    for name in os.listdir(wd):
        if name.startswith("stats_g"):
            with open(os.path.join(wd, name)) as f:
                st = json.load(f)
            assert st["device"].startswith("cuda")
            assert st["k2_launches"] == st["supersteps"] > 0, st


@pytest.mark.parametrize("world,pid", [(1, 0), (2, 1), (3, 0)])
def test_worker_rows_scores_match_plain(cuda, tmp_path, world, pid):
    """K2 over the CSR of a worker's rows with the full label vector as its
    lookup, on the card, bitwise equal to its plain version."""
    from repro_torch.cluster import write_edge_shards
    from repro_torch.cluster.worker import owned_csr
    g = generators.powerlaw_ba(6_000, 6, seed=3)
    man = write_edge_shards(g, str(tmp_path), num_hosts=4)
    owned = [h for h in range(4) if h % world == pid]
    rows, row_ptr, src, dst, w = owned_csr(str(tmp_path), owned,
                                           man["v_per_host"], g.num_vertices)
    k = 32
    labels = torch.from_numpy(np.random.default_rng(pid).integers(
        0, k, g.num_vertices).astype(np.int32))
    args = [torch.from_numpy(a) for a in (row_ptr, dst, w)]
    own = labels[torch.from_numpy(rows)]
    want = spinner_scores(own, *args, k, lookup=labels)
    n = spinner_scores.launches
    got = spinner_scores(own.to(cuda), *(a.to(cuda) for a in args), k,
                         lookup=labels.to(cuda))
    assert spinner_scores.launches == n + 1
    assert _bits_equal(got.cpu(), want)


def test_deployment_recovers_on_card(cuda, tmp_path):
    """A CUDA-backend tenant under a ClusterDeployment: a window whose run
    fails is recovered from its snapshot and retried, equal to a twin
    session."""
    from repro_torch.cluster import ClusterDeployment
    from repro_torch.serve import PartitionScheduler, traffic
    g = traffic.tenant_graph(20_000, seed=1, k_nbrs=16)
    cfg = SpinnerConfig(k=16, seed=1)
    opts = EngineOptions(device=cuda, score_backend="cuda")
    dep = ClusterDeployment(str(tmp_path))
    sched = PartitionScheduler(deployment=dep)
    sched.add_tenant("a", g, cfg, opts)
    sched.submit("a", "partition")
    assert sched.drain() == 1
    sess = sched.tenants["a"].session
    orig, armed = sess._fast_bind, [True]

    def poisoned(*a, **kw):        # fails after the window's edges joined
        if armed[0]:               # the delta log, as a failed launch does
            armed[0] = False
            raise RuntimeError("injected dispatch failure")
        return orig(*a, **kw)

    sess._fast_bind = poisoned
    b = traffic.random_edge_updates(g.num_vertices, 400,
                                    np.random.default_rng(5))
    tk = sched.submit("a", "edge_updates", edge_updates=b)
    assert sched.drain() == 1 and not tk.failed, tk.error
    assert sched.stats()["recoveries"] == 1 == dep.recoveries
    twin = open_session(g, cfg, opts)
    twin.partition(record_history=False)
    want = twin.adapt(edge_updates=b, record_history=False)
    np.testing.assert_array_equal(tk.result.labels, want.labels)
    assert tk.result.iterations == want.iterations


# ---------------------------------------------------------------------------
# the LLM models on the card against the CPU

def _rel(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_full_width_stablelm_layer_on_card(cuda):
    """One stablelm-1.6b layer at full width (d_model 2048, 32 heads,
    d_ff 5632), forward and backward on the card against the CPU."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import common, dense as dense_mod
    common.use_reference_numerics()
    cfg = ARCHS["stablelm-1.6b"]
    specs = dense_mod.layer_param_specs(cfg, 1)
    lp = common.tree_map(lambda t: t[0], common.init_from_specs(
        specs, torch.Generator().manual_seed(0)))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 512, cfg.d_model, generator=gen).bfloat16()
    co = torch.randn(1, 512, cfg.d_model, generator=gen)

    def run(dev):
        def loss(tree):
            out, _ = dense_mod._layer(tree["x"], tree["lp"], cfg)
            return (out.float() * co.to(dev)).sum(), out
        tree = common.tree_map(lambda t: t.to(dev), {"x": x, "lp": lp})
        leaves = [t.detach().requires_grad_(True)
                  for t in common.tree_leaves(tree)]
        tree = common.tree_unflatten(tree, leaves)
        val, out = loss(tree)
        grads = torch.autograd.grad(val, leaves)
        return out.detach(), grads

    out_c, g_c = run(torch.device("cpu"))
    out_g, g_g = run(cuda)
    np.testing.assert_allclose(out_g.float().cpu().numpy(),
                               out_c.float().numpy(), atol=5e-2, rtol=2e-2)
    for a, b in zip(g_g, g_c):
        assert _rel(a, b) < 2e-2


def test_flash_attention_on_card(cuda):
    """The flash autograd.Function on the card against the CPU: forward
    and grads, causal GQA with several blocks a side."""
    from repro_torch.models.attention import chunked_attention
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2, 256, 8, 64, generator=gen)
    k, v = (torch.randn(2, 256, 2, 64, generator=gen) for _ in range(2))
    co = torch.randn(2, 256, 8, 64, generator=gen)

    def run(dev):
        ts = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = chunked_attention(*ts, causal=True, chunk_q=64, chunk_kv=64)
        grads = torch.autograd.grad((out.float() * co.to(dev)).sum(), ts)
        return out.detach().float().cpu(), [g.cpu() for g in grads]

    out_c, g_c = run(torch.device("cpu"))
    out_g, g_g = run(cuda)
    np.testing.assert_allclose(out_g.numpy(), out_c.numpy(), atol=1e-2,
                               rtol=1e-2)
    for a, b in zip(g_g, g_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen3-moe-235b-a22b",
                                  "rwkv6-1.6b", "zamba2-7b",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_reduced_train_steps_on_card(cuda, arch):
    """Three train steps of a reduced model on the card from the CPU run's
    weights (encdec and vlm on the frontend stub): the same losses (rtol
    1e-3) and grad norms (rtol 2e-2)."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.models import build, common, init_params
    from repro_torch.optim import adamw
    from repro_torch.train import steps as train_steps
    common.use_reference_numerics()
    cfg = ARCHS[arch].reduced()
    api = build(cfg)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    params = init_params(api, torch.Generator().manual_seed(0))

    def run(dev):
        state = train_steps.init_train_state(
            common.tree_map(lambda t: t.to(dev, copy=True), params))
        step = train_steps.make_train_step(api, opt)
        out = []
        for i in range(3):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipeline.batch_at(data, i).items()}
            stub = pipeline.frontend_stub(
                cfg, ShapeConfig("train", 64, 4, "train"), i)
            if stub is not None:
                key = "src_embed" if cfg.family == "encdec" else "img_embed"
                b[key] = torch.from_numpy(stub).to(dev, torch.bfloat16)
            state, st = step(state, b)
            out.append((float(st["loss"]), float(st["grad_norm"])))
        return out

    for (lg, gg), (lc, gc) in zip(run(cuda), run(torch.device("cpu"))):
        assert lg == pytest.approx(lc, rel=1e-3)
        assert gg == pytest.approx(gc, rel=2e-2)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b",
                                  "seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_reduced_family_on_card(cuda, arch):
    """A reduced rwkv / hybrid / encdec / vlm model on the card against
    the CPU on the same weights and inputs: the loss (rtol 1e-3), the
    prefill logits, four decode steps and the final cache or state (atol
    5e-2)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve_llm import frontend_inputs, grow_cache
    from repro_torch.models import build, common, init_params
    common.use_reference_numerics()
    cfg = ARCHS[arch].reduced()
    api = build(cfg)
    params = init_params(api, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    labels = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    extras = frontend_inputs(cfg, 2, 24, gen, "cpu")

    def run(dev):
        p = common.tree_map(lambda t: t.to(dev), params)
        ex = {k: v.to(dev) for k, v in extras.items()}
        tok = tokens.to(dev)
        with torch.no_grad():
            loss = float(api.loss(p, {"tokens": tok,
                                      "labels": labels.to(dev), **ex}))
            logits, cache = api.prefill(p, {"tokens": tok[:, :16], **ex})
            cache = grow_cache(cache, 20, cfg.family)
            outs = [logits.float().cpu()]
            for i in range(16, 20):
                lg, cache = api.decode(p, {"token": tok[:, i], "pos": i},
                                       cache)
                outs.append(lg.float().cpu())
        return loss, outs, [c.cpu() for c in common.tree_leaves(cache)]

    (lc, oc, cc), (lg, og, cg) = run(torch.device("cpu")), run(cuda)
    assert lg == pytest.approx(lc, rel=1e-3)
    for a, b in zip(og + cg, oc + cc):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=5e-2)


@pytest.mark.parametrize("scan", ["wkv", "ssd"])
def test_chunk_scans_on_card(cuda, scan):
    """``wkv_chunked`` / ``ssd_chunked`` (each chunk step checkpointed) on
    the card against the CPU: outputs, states and gradients at rwkv6's
    head shape (64) and zamba2's chunk (128)."""
    from repro_torch.models import rwkv, ssm
    gen = torch.Generator().manual_seed(3)
    if scan == "wkv":
        b, s, h, hd = 2, 128, 4, 64
        args = [torch.randn(b, s, h, hd, generator=gen) * 0.5
                for _ in range(3)]
        args += [-torch.exp(torch.randn(b, s, h, hd, generator=gen) * 0.5
                            - 1),
                 torch.randn(h, hd, generator=gen) * 0.3,
                 torch.randn(b, h, hd, hd, generator=gen) * 0.1]
        fn, chunk = rwkv.wkv_chunked, 32
    else:
        b, s, h, hd, n = 2, 256, 4, 64, 64
        args = [torch.randn(b, s, h, hd, generator=gen) * 0.5,
                torch.randn(b, s, n, generator=gen) * 0.5,
                torch.randn(b, s, n, generator=gen) * 0.5,
                torch.rand(b, s, h, generator=gen) * 0.5 + 0.01,
                -torch.exp(torch.randn(h, generator=gen) * 0.3),
                torch.randn(b, h, n, hd, generator=gen) * 0.1]
        fn, chunk = ssm.ssd_chunked, 128

    def run(dev):
        ts = [a.to(dev).requires_grad_(True) for a in args]
        out, st = fn(*ts, chunk)
        grads = torch.autograd.grad(out.float().square().sum()
                                    + st.square().sum(), ts)
        return [out.detach().float().cpu(), st.detach().cpu()] + [
            g.cpu() for g in grads]

    for a, b in zip(run(cuda), run(torch.device("cpu"))):
        assert _rel(a, b) < 1e-2
