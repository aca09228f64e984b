"""The port's tile autotuner (``repro_torch.kernels.autotune``) and its
hooks, against the reference's on the CPU.

The reference tunes its Pallas backend's ``(tile_v, tile_e)``; the port
tunes the CUDA backend's ``(warps, rows)``.  The option semantics are held
side by side -- the reference on ``"pallas"`` / ``"xla"``, the port on
``"cuda"`` / ``"torch"`` -- and whole runs under every mode must give the
reference's labels, loads and iterations (on the CPU the tile reaches no
kernel; on the card ``tests/test_torch_gpu.py`` holds each tile to the
plain versions).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import EngineOptions as RefOptions
from repro.core import SpinnerConfig as RefConfig
from repro.core import engine as ref_engine
from repro.core import generators as ref_gen
from repro.core import partition as ref_partition
from repro.core.session import PartitionSession as RefSession
from repro.kernels import autotune as ref_autotune
from repro.kernels.ops import PallasTiledBackend
from repro_torch import rng
from repro_torch.convert import graph_from_reference
from repro_torch.core import EngineOptions, SpinnerConfig, distributed
from repro_torch.core import engine, generators, open_session, partition
from repro_torch.core.graph import add_edges
from repro_torch.kernels import autotune, ref
from repro_torch.kernels.ops import CudaCsrBackend
from repro_torch.kernels.spinner_scores import (MAX_SMEM_BYTES, clip_tile,
                                                fused_layout,
                                                fused_update,
                                                fused_update_frontier,
                                                fused_update_seeded, layout,
                                                max_rows, scores_layout,
                                                spinner_scores)
from repro_torch.launch.mesh import make_partition_mesh
from repro_torch.serve.scheduler import PartitionScheduler


def _todays_layout(k, bufs, group_bytes, fixed, head):
    """The layout every launch took before the tile was an argument."""
    def r16(n):
        return -(-n // 16) * 16
    stride = k | 1
    rows = max(1, min(32, group_bytes // (bufs * 4 * stride)))
    per_warp = fixed + r16(bufs * rows * stride * 4)
    warps = min(8, (MAX_SMEM_BYTES - head) // per_warp)
    if warps < 1:
        return None
    return warps, rows, head + warps * per_warp


@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 128, 1000, 58043])
def test_default_tile_is_todays_layout(k):
    """``tile=None`` (and ``(None, None)``) launch with exactly the warps,
    rows and shared memory of the fixed layout."""
    head = -(-8 * k // 16) * 16
    want = {"scores": _todays_layout(k, 1, 8448, 272, 0),
            "fused": _todays_layout(k, 2, 12672, 656, head),
            "seeded": _todays_layout(k, 3, 12672, 656, head)}
    got = {}
    for form in want:
        try:
            got[form] = layout(k, form)
            assert layout(k, form, (None, None)) == got[form]
        except ValueError:
            got[form] = None
    assert got == want
    assert scores_layout(k) == got["scores"] or got["scores"] is None
    if got["fused"] is not None:
        assert fused_layout(k, False) == got["fused"]
        assert layout(k, "frontier") == got["fused"]
    if got["seeded"] is not None:
        assert fused_layout(k, True) == got["seeded"]


@pytest.mark.parametrize("k,form,tile,match", [
    (32, "fused", (8, 0), "rows=0 outside"),
    (32, "scores", (8, 33), "rows=33 outside"),
    (128, "fused", (8, 13), r"rows=13 outside \[1, 12\]"),
    (128, "seeded", (8, 9), r"rows=9 outside \[1, 8\]"),
    (32, "fused", (0, 8), "at least one warp"),
    (512, "fused", (32, 3), "above MAX_SMEM_BYTES"),
    (32, "warp", (8, 8), "unknown kernel form"),
])
def test_layout_refuses_bad_tile(k, form, tile, match):
    with pytest.raises(ValueError, match=match):
        layout(k, form, tile)


def test_clip_tile_fits_every_form():
    """A backend's one tile, cut per form, is a valid launch of each."""
    for k in (2, 32, 64, 128, 512, 5000):
        for tile in autotune.CANDIDATES + ((None, None), (3, None)):
            for form in ("scores", "fused", "frontier", "seeded"):
                w, r = clip_tile(k, form, tile)
                assert r <= max_rows(k, form)
                assert layout(k, form, (w, r))[2] <= MAX_SMEM_BYTES
    assert clip_tile(32, "fused", None) is None


def _inputs(seed=0, v=300, k=5):
    g = generators.watts_strogatz(v, 6, 0.3, seed=seed)
    csr = g.to_device("cpu")
    gen = np.random.default_rng(seed)
    labels = torch.from_numpy(gen.integers(0, k, v).astype(np.int32))
    pen = torch.from_numpy(gen.random(k).astype(np.float32))
    noise = rng.uniform(rng.PRNGKey(seed), (v, k), 0.0, 1e-3, device="cpu")
    return g, csr, labels, pen, noise, k


def test_wrappers_ignore_tile_on_cpu():
    """On CPU tensors every wrapper runs its plain version whatever the
    tile."""
    g, csr, labels, pen, noise, k = _inputs()
    base = (csr.row_ptr, csr.dst, csr.weight)
    v = g.num_vertices
    valid = torch.arange(v) < v - 7
    acc = ref.spinner_scores_ref(labels, csr.src, csr.dst, csr.weight, v, k)
    for tile in ((4, 8), (16, 1)):
        assert torch.equal(spinner_scores(labels, *base, k, tile=tile),
                           spinner_scores(labels, *base, k))
        pairs = [
            (fused_update(labels, *base, csr.deg_w, pen, noise, v - 3, k,
                          1e-6, True, tile=tile),
             fused_update(labels, *base, csr.deg_w, pen, noise, v - 3, k,
                          1e-6, True)),
            (fused_update_frontier(labels, *base, csr.deg_w, pen, noise,
                                   valid, k, 1e-6, False, tile=tile),
             fused_update_frontier(labels, *base, csr.deg_w, pen, noise,
                                   valid, k, 1e-6, False)),
            (fused_update_seeded(labels, *base, csr.deg_w, pen, noise, v, k,
                                 1e-6, True, acc, tile=tile),
             fused_update_seeded(labels, *base, csr.deg_w, pen, noise, v, k,
                                 1e-6, True, acc))]
        for got, want in pairs:
            assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- option semantics, side by side with the reference's _autotuned ------

@pytest.fixture(scope="module")
def ws():
    g = ref_gen.watts_strogatz(500, 8, 0.2, seed=13)
    return g, graph_from_reference(g)


def _ref_case(case):
    pinned = PallasTiledBackend(tile_v=256, tile_e=128)
    return {"off": RefOptions(score_backend="pallas", autotune="off"),
            "auto_by_name": RefOptions(score_backend="pallas"),
            "auto_pinned": RefOptions(score_backend=pinned),
            "on_pinned": RefOptions(score_backend=pinned, autotune="on"),
            "scatter": RefOptions(score_backend="xla", autotune="on"),
            "bogus": RefOptions(score_backend="pallas",
                                autotune="bogus")}[case]


def _port_case(case):
    pinned = CudaCsrBackend(warps=16, rows=8)
    cpu = dict(device="cpu")
    return {"off": EngineOptions(autotune="off", **cpu),
            "auto_by_name": EngineOptions(**cpu),
            "auto_pinned": EngineOptions(score_backend=pinned, **cpu),
            "on_pinned": EngineOptions(score_backend=pinned, autotune="on",
                                       **cpu),
            "scatter": EngineOptions(score_backend="torch", autotune="on",
                                     **cpu),
            "bogus": EngineOptions(autotune="bogus", **cpu)}[case]


def _outcome(tuned_of, opts, want_of):
    """``"same"`` (the options object itself), ``"tuned"`` (the backend
    now carries the model's choice) or the error raised."""
    try:
        tuned = tuned_of(opts)
    except ValueError as e:
        return ("ValueError", "autotune" in str(e))
    if tuned is opts:
        return "same"
    return "tuned" if want_of(tuned.backend()) else "wrong tile"


@pytest.mark.parametrize("case", ["off", "auto_by_name", "auto_pinned",
                                  "on_pinned", "scatter", "bogus"])
def test_autotuned_semantics_match_reference(ws, case):
    ref_g, g = ws
    k = 5
    ref_padded, _ = ref_engine.padded_view(ref_g, RefOptions())
    padded, _ = engine.padded_view(g, EngineOptions(device="cpu"))
    ref_want = ref_autotune.choose_tile_config(ref_padded, k)
    want = autotune.choose_tile_config(padded, k)
    ref_out = _outcome(
        lambda o: ref_engine._autotuned(ref_g, RefConfig(k=k), o),
        _ref_case(case), lambda b: (b.tile_v, b.tile_e) == ref_want[:2])
    port_out = _outcome(
        lambda o: engine._autotuned(g, SpinnerConfig(k=k), o),
        _port_case(case), lambda b: (b.warps, b.rows) == want[:2])
    assert port_out == ref_out


def test_tile_is_part_of_the_batch_signature():
    a = engine.backend_signature(CudaCsrBackend())
    b = engine.backend_signature(CudaCsrBackend(warps=4, rows=8))
    assert a != b
    assert a == engine.backend_signature(CudaCsrBackend())


# -- the model --------------------------------------------------------------

def test_choice_is_deterministic_and_memoized():
    g1 = generators.watts_strogatz(710, 8, 0.2, seed=13)
    g2 = generators.watts_strogatz(710, 8, 0.2, seed=13)
    c1 = autotune.choose_tile_config(g1, 8)
    assert autotune.choose_tile_config(g2, 8) == c1
    assert autotune.choose_tile_config(g1, 8) is c1     # the memo
    assert c1[:2] in autotune.candidates(8)
    assert c1[2] == layout(8, "fused", c1[:2])[2]


@pytest.mark.parametrize("k,ndev,kernel", [(16, 1, "fused"),
                                           (16, 1, "scores"),
                                           (128, 2, "fused"),
                                           (512, 1, "scores")])
def test_sweep_covers_candidates(k, ndev, kernel):
    g = generators.powerlaw_ba(400 + k + ndev, 6, seed=3)
    rows = autotune.sweep(g, k, ndev=ndev, kernel=kernel)
    assert [(r["warps"], r["rows"]) for r in rows] == \
        autotune.candidates(k, kernel)
    costs = [r["cost_s"] for r in rows]
    best = rows[int(np.argmin(costs))]           # the first minimum
    assert autotune.choose_tile_config(g, k, ndev=ndev, kernel=kernel) == \
        (best["warps"], best["rows"], best["smem_bytes"])
    for r in rows:
        assert r["cost_s"] > 0 and r["grid"] >= 1
        assert set(r) == {"warps", "rows", "smem_bytes", "grid", "groups",
                          "max_group_entries", "cost_s"}


def test_schedule_counts_real_entries_and_groups():
    """Groups of consecutive rows, weight-0 filler left out of the
    degrees, and ``csr::grid_for``'s grid at these sizes."""
    g = generators.powerlaw_ba(1000, 5, seed=4)
    padded, _ = engine.padded_view(g, EngineOptions(device="cpu"))
    deg = autotune._shard_degrees(padded, 1)[0]
    assert deg.shape == (padded.num_vertices,)
    np.testing.assert_array_equal(deg[:g.num_vertices], np.diff(g.row_ptr))
    assert not deg[g.num_vertices:].any()
    f = autotune.slot_features(deg, 4, 8, 16)
    groups = -(-deg.shape[0] // 8)
    assert f["groups"] == groups and f["grid"] == -(-groups // 4)
    sums = [int(deg[i:i + 8].sum()) for i in range(0, deg.shape[0], 8)]
    assert f["max_group_entries"] == max(sums)
    batches = sum(-(-s // autotune.BATCH) for s in sums)
    col = {name: i for i, name in enumerate(autotune.FEATURES)}
    assert f["slots"][:, col["a"]].sum() == batches \
        == f["sms"][:, col["a"]].sum()
    assert f["slots"][:, col["c"]].sum() == groups
    # one resident block of 4 warps an SM here: its shared memory's share
    share = (layout(16, "fused", (4, 8))[2] + 1024) / autotune.SMEM_PER_SM
    assert np.isclose(f["slots"][:, col["a_smem"]].sum(), batches * share,
                      rtol=0.01)
    # the whole card: 132 SMs, each holding what its resources allow
    big = np.full(2_000_000, 16)
    f = autotune.slot_features(big, 8, 32, 32)
    assert f["grid"] == autotune.SMS * autotune.blocks_per_sm(
        "fused", 8, layout(32, "fused")[2])


def test_modeled_traffic_removes_score_roundtrip():
    split, fused = autotune.modeled_traffic(1024, 8192, 128)
    vk = 1024 * 128 * 4
    assert sum(split.values()) - sum(fused.values()) == 2 * vk
    assert "score_write" not in fused and "score_read" not in fused


# -- the session and the sharded stats ---------------------------------------

def _tile_of(padded, k, ndev=1):
    w, r, smem = autotune.choose_tile_config(padded, k, ndev=ndev)
    return {"warps": w, "rows": r, "smem_bytes": smem}


def test_stats_surface_tile_config(ws):
    ref_g, g = ws
    cfg = SpinnerConfig(k=5, max_iters=90, seed=7)
    with open_session(g, cfg, EngineOptions(device="cpu")) as s:
        d = s.stats()
    padded, _ = engine.padded_view(g, EngineOptions(device="cpu"))
    assert d["score_backend"] == "cuda" and d["fused_update"] == "on"
    assert d["tile_config"] == _tile_of(padded, 5)
    with RefSession(ref_g, RefConfig(k=5, max_iters=90, seed=7),
                    RefOptions(score_backend="pallas")) as rs:
        assert set(rs.stats()["tile_config"]) == {"tile_v", "tile_e",
                                                   "k_pad"}
    with open_session(g, cfg, EngineOptions(device="cpu",
                                            score_backend="torch")) as s:
        assert "tile_config" not in s.stats()
    with RefSession(ref_g, RefConfig(k=5, max_iters=90, seed=7),
                    RefOptions(score_backend="xla")) as rs:
        assert "tile_config" not in rs.stats()


def test_mesh_stats_surface_via_comm_stats(ws):
    _, g = ws
    cfg = SpinnerConfig(k=5, max_iters=91, seed=7)
    mesh = make_partition_mesh(device="cpu")
    opts = EngineOptions(device="cpu", engine="sharded", mesh=mesh)
    padded, _ = engine.padded_view(g, opts)
    with open_session(g, cfg, opts) as s:
        ex = s.stats()["exchange"]
    assert ex["score_backend"] == "cuda" and ex["fused_update"] == "on"
    assert ex["tile_config"] == _tile_of(padded, 5, ndev=1)
    sg = distributed.shard_layout(padded, 1, pad=True)
    pinned = EngineOptions(device="cpu",
                           score_backend=CudaCsrBackend(warps=4, rows=8))
    assert distributed.comm_stats(sg, cfg, pinned)["tile_config"] == {
        "warps": 4, "rows": 8, "smem_bytes": layout(5, "fused", (4, 8))[2]}
    on = dataclasses.replace(pinned, autotune="on")
    assert distributed.comm_stats(sg, cfg, on, graph=padded)[
        "tile_config"] == _tile_of(padded, 5, ndev=1)


def test_warm_same_bucket_adapt_keeps_tile_and_batch_key():
    """The first graph of a bucket picks the tile; a warm same-bucket
    adapt (a rebuilt graph, then the delta fast path) keeps it and the
    batch key -- the port's form of the reference's zero new compiles."""
    g = generators.watts_strogatz(600, 8, 0.2, seed=11)
    cfg = SpinnerConfig(k=5, max_iters=40, seed=7)
    gen = np.random.default_rng(1)
    with open_session(g, cfg, EngineOptions(device="cpu",
                                            autotune="on")) as s:
        s.partition(record_history=False)
        tile, key = s.stats()["tile_config"], s.batch_key()
        g2 = add_edges(g, gen.integers(0, 600, 30), gen.integers(0, 600, 30),
                       num_vertices=602)
        assert engine.graph_buckets(g2) == engine.graph_buckets(g)
        s.adapt(g2, record_history=False)
        assert s.stats()["tile_config"] == tile
        assert s.batch_key() == key
        s.adapt(edge_updates=(gen.integers(0, 602, 20),
                              gen.integers(0, 602, 20)),
                record_history=False)
        assert s.stats()["delta"]["fast_adapts"] == 1
        assert s.stats()["tile_config"] == tile
        assert s.batch_key() == key


def test_ksweep_warms_the_new_k_tile():
    g = generators.watts_strogatz(730, 8, 0.2, seed=2)
    sched = PartitionScheduler()
    sched.add_tenant("t", g, SpinnerConfig(k=4, max_iters=5, seed=1),
                     EngineOptions(device="cpu"), partition=True)
    sched.submit("t", "resize", k=9)
    padded, _ = engine.padded_view(g, EngineOptions(device="cpu"))
    key = (padded.num_vertices, padded.num_directed_entries, 9, 1, "fused")
    autotune._CHOICE_CACHE.pop(key, None)
    policy = next(p for p in sched.policies
                  if p.name == "ksweep_precompile")
    policy.run(sched)
    assert key in autotune._CHOICE_CACHE


# -- whole runs: every mode gives the reference's result -----------------

@pytest.mark.parametrize("opts", [
    dict(autotune="off"), dict(autotune="on"), dict(),
    dict(score_backend=CudaCsrBackend(warps=4, rows=8)),
    dict(score_backend=CudaCsrBackend(warps=16, rows=1), autotune="off"),
    dict(autotune="on", fused_update="off")],
    ids=["off", "on", "auto", "pinned", "pinned_off", "on_split"])
def test_partition_under_autotune_matches_reference(powerlaw, opts):
    cfg = dict(k=8, seed=3)
    want = ref_partition(powerlaw, RefConfig(**cfg), engine="fused",
                         record_history=False)
    got = partition(graph_from_reference(powerlaw), SpinnerConfig(**cfg),
                    engine="fused", record_history=False,
                    options=EngineOptions(device="cpu", **opts))
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    np.testing.assert_array_equal(got.loads, np.asarray(want.loads))
    assert got.iterations == want.iterations
    assert got.halted == want.halted
