"""Frontier mode and the delta segment of the port against the reference,
on the CPU.

  * the plain frontier propose (``ref.frontier_propose_ref``, and the
    kernel wrapper on CPU tensors) against the reference's Pallas
    megakernel with ``frontier=True`` in interpret mode: on active rows
    ``best`` / ``tot_best`` / ``tot_cur`` equal and M(l) bitwise equal;
    inactive rows are ``(label, 0, 0)`` in the port (the TPU computes the
    inactive rows of an active tile, so those are not compared);
  * the delta segment: base CSR + merged appended entries score exactly
    as the rebuilt graph does;
  * whole frontier runs (``engine.run_frontier``) against
    ``repro.core.engine.run_frontier``: labels, loads, iterations, halted
    and the per-iteration scored counts identical.

Inputs are made from numpy seeds and handed to both sides; every
comparison is bitwise (score sums are exact integers in float32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineOptions as RefOptions
from repro.core import SpinnerConfig as RefConfig
from repro.core import add_edges as ref_add_edges
from repro.core import engine as ref_engine
from repro.core import generators as ref_gen
from repro.core.graph import build_tiled_csr
from repro.core.spinner import prepare_init as ref_prepare_init
from repro.kernels.spinner_scores import fused_update_from_tiles
from repro_torch.convert import graph_from_reference
from repro_torch.core import (EngineOptions, SpinnerConfig, delta, engine,
                              partition)
from repro_torch.core.spinner import prepare_init
from repro_torch.kernels import ref
from repro_torch.kernels.spinner_scores import (fused_update,
                                                fused_update_frontier)

KS = [2, 7, 32, 130]
MASKS = ["random10", "sparse", "none", "all"]


@pytest.fixture(scope="module")
def padded():
    """A hub-heavy graph on its bucketed layout (weight-0 pad entries)."""
    g = ref_gen.powerlaw_ba(400, 5, seed=2)
    return ref_engine.padded_view(g, ref_engine.EngineOptions())


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _mask(kind: str, v: int, num_real: int, seed: int) -> np.ndarray:
    """``real & active`` masks: 10% random, a handful of vertices (most
    tiles of the reference's layout have no active row), none, all."""
    gen = np.random.default_rng(seed)
    real = np.arange(v) < num_real
    if kind == "random10":
        return real & (gen.random(v) < 0.1)
    if kind == "sparse":
        act = np.zeros(v, bool)
        act[gen.choice(num_real, 5, replace=False)] = True
        return act
    return real & (kind == "all")


@functools.partial(jax.jit, static_argnames=("k", "k_pad", "weighted"))
def _pallas_frontier(labels, deg_t, noise, valid, pen, src_local, dst, w,
                     perm, inv_perm, *, k, k_pad, weighted):
    return fused_update_from_tiles(
        labels, labels, deg_t, noise, valid, pen, src_local, dst, w, perm,
        inv_perm, tile_v=128, k_pad=k_pad, k=k, current_bonus=1e-6,
        degree_weighted=weighted, interpret=True, frontier=True)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("k", KS)
def test_frontier_propose_matches_pallas(padded, k, kind):
    g, num_real = padded
    v = g.num_vertices
    gen = np.random.default_rng(300 + k)
    labels = gen.integers(0, k, v).astype(np.int32)
    noise = (gen.random((v, k)) * 1e-7).astype(np.float32)
    pen = gen.uniform(0.8, 1.2, k).astype(np.float32)
    valid = _mask(kind, v, num_real, seed=k)
    weighted = k % 2 == 0
    tiled = build_tiled_csr(g, tile_v=128, tile_e=128)
    want = _pallas_frontier(
        jnp.asarray(labels), jnp.asarray(tiled.deg_t), jnp.asarray(noise),
        jnp.asarray(valid), jnp.asarray(pen), jnp.asarray(tiled.src_local),
        jnp.asarray(tiled.dst), jnp.asarray(tiled.weight),
        jnp.asarray(tiled.perm), jnp.asarray(tiled.inv_perm), k=k,
        k_pad=-(-k // 128) * 128, weighted=weighted)
    want = [np.asarray(x) for x in want]
    csr = graph_from_reference(g).to_device("cpu")
    t_lab, t_pen, t_noise = (torch.from_numpy(x) for x in (labels, pen,
                                                           noise))
    t_valid = torch.from_numpy(valid)
    plain = ref.frontier_propose_ref(t_lab, csr.src, csr.dst, csr.weight,
                                     csr.deg_w, t_pen, t_noise, t_valid, k,
                                     1e-6, weighted)
    wrapped = fused_update_frontier(t_lab, csr.row_ptr, csr.dst, csr.weight,
                                    csr.deg_w, t_pen, t_noise, t_valid, k,
                                    1e-6, weighted)
    for got in (plain, wrapped):
        got = [x.numpy() for x in got]
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(_bits(a[valid]), _bits(b[valid]))
        np.testing.assert_array_equal(_bits(got[3]), _bits(want[3]))
        np.testing.assert_array_equal(got[0][~valid], labels[~valid])
        assert not got[1][~valid].any() and not got[2][~valid].any()
    # the want mask the runner carries forward is the same on every row
    np.testing.assert_array_equal((want[0] != labels) & valid,
                                  (plain[0].numpy() != labels) & valid)


def test_frontier_all_active_is_the_base_form(padded):
    """With every real row active the frontier variant is the base form
    with pads masked to the no-op proposal."""
    g, num_real = padded
    v, k = g.num_vertices, 9
    gen = np.random.default_rng(5)
    labels = torch.from_numpy(gen.integers(0, k, v).astype(np.int32))
    noise = torch.from_numpy((gen.random((v, k)) * 1e-7).astype(np.float32))
    pen = torch.from_numpy(gen.uniform(0.8, 1.2, k).astype(np.float32))
    csr = graph_from_reference(g).to_device("cpu")
    valid = torch.arange(v) < num_real
    base = fused_update(labels, csr.row_ptr, csr.dst, csr.weight, csr.deg_w,
                        pen, noise, num_real, k, 1e-6, True)
    front = fused_update_frontier(labels, csr.row_ptr, csr.dst, csr.weight,
                                  csr.deg_w, pen, noise, valid, k, 1e-6, True)
    for a, b in zip(base[:3], front[:3]):
        assert torch.equal(a[valid], b[valid])
    assert torch.equal(base[3], front[3])


def _merged(g_ref, batches):
    """The port's device segment after merging ``batches`` into the padded
    base of ``g_ref``, and the reference's rebuilt graph."""
    g = graph_from_reference(g_ref)
    padded, _ = engine.padded_view(g, EngineOptions(device="cpu"))
    tracker = delta.DeltaTracker(g)
    dd = delta.init_single_csr(padded.to_device("cpu"),
                               g.num_directed_entries)
    rebuilt = g_ref
    for src, dst in batches:
        out = delta.apply_delta(tracker, dd, src, dst, engine.merge_delta)
        assert out is not None
        dd, plan, nbytes = out
        assert nbytes == 12 * plan.num_entries
        rebuilt = ref_add_edges(rebuilt, src, dst)
    return dd, tracker, rebuilt


def test_delta_segment_scores_as_the_rebuilt_graph(padded):
    g_ref = ref_gen.powerlaw_ba(400, 5, seed=2)
    gen = np.random.default_rng(8)
    v = g_ref.num_vertices
    u = int(g_ref.src[g_ref.weight == 1][0])
    w_ = int(g_ref.dst[g_ref.weight == 1][0])
    batches = [(gen.integers(0, v, 40), gen.integers(0, v, 40)),
               (np.array([w_, u, 3, 3]), np.array([u, w_, 3, 9]))]
    dd, tracker, rebuilt = _merged(g_ref, batches)
    assert tracker.total_weight == float(rebuilt.total_weight)
    re_pad, _ = ref_engine.padded_view(rebuilt, ref_engine.EngineOptions())
    assert re_pad.num_vertices == dd.deg_w.shape[0]
    np.testing.assert_array_equal(dd.deg_w.numpy(), re_pad.deg_w)
    # the segment is sorted by source and its row pointer counts it
    assert torch.equal(dd.src, torch.sort(dd.src, stable=True).values)
    assert int(dd.row_ptr[-1]) == dd.num_entries
    np.testing.assert_array_equal(ref.csr_src(dd.row_ptr).numpy(),
                                  dd.src.numpy())
    k = 6
    labels = np.random.default_rng(1).integers(0, k, re_pad.num_vertices)
    t_lab = torch.from_numpy(labels.astype(np.int32))
    got = ref.spinner_scores_ref(t_lab, dd.csr.src, dd.csr.dst,
                                 dd.csr.weight, re_pad.num_vertices, k,
                                 (dd.src, dd.dst, dd.w))
    want = ref.spinner_scores_ref(t_lab, *(torch.from_numpy(np.asarray(a))
                                           for a in (re_pad.src, re_pad.dst,
                                                     re_pad.weight)),
                                  re_pad.num_vertices, k)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    # the kernel wrapper folds the CSR form of the same segment
    noise = torch.zeros(re_pad.num_vertices, k)
    pen = torch.ones(k)
    valid = torch.ones(re_pad.num_vertices, dtype=torch.bool)
    seg = (dd.row_ptr, dd.dst, dd.w)
    a = fused_update_frontier(t_lab, dd.csr.row_ptr, dd.csr.dst,
                              dd.csr.weight, dd.deg_w, pen, noise, valid, k,
                              1e-6, True, seg)
    b = ref.frontier_propose_ref(t_lab, *(torch.from_numpy(np.asarray(x))
                                          for x in (re_pad.src, re_pad.dst,
                                                    re_pad.weight)),
                                 dd.deg_w, pen, noise, valid, k, 1e-6, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y.numpy()))


def test_delta_overflow_commits_nothing():
    g_ref = ref_gen.watts_strogatz(300, 4, 0.0, seed=1)
    g = graph_from_reference(g_ref)
    padded, _ = engine.padded_view(g, EngineOptions(device="cpu"))
    tracker = delta.DeltaTracker(g)
    dd = delta.init_single_csr(padded.to_device("cpu"),
                               g.num_directed_entries)
    slack = dd.e_capacity - dd.next_slot
    v = g.num_vertices
    src = np.arange(0, v - 7)
    assert 2 * src.size > slack
    before = tracker.total_weight
    assert delta.apply_delta(tracker, dd, src, src + 7,
                             engine.merge_delta) is None
    assert tracker.total_weight == before and not tracker.pairs
    assert dd.next_slot == g.num_directed_entries


def test_device_loads_equal_compute_loads():
    g_ref = ref_gen.powerlaw_ba(500, 4, seed=3)
    g = graph_from_reference(g_ref)
    padded, _ = engine.padded_view(g, EngineOptions(device="cpu"))
    labels = torch.from_numpy(np.random.default_rng(2).integers(
        0, 7, g.num_vertices).astype(np.int32))
    from repro_torch.core.spinner import compute_loads
    got = engine.device_loads(engine.pad_labels(labels, padded.num_vertices),
                              padded.to_device("cpu").deg_w, 7)
    assert torch.equal(got, compute_loads(g, labels, 7))


# (port backend, port fused_update) against (reference backend, fused)
RUNS = [("cuda", "auto", "xla", "on"), ("torch", "off", "xla", "off"),
        ("torch", "on", "xla", "on")]


@pytest.mark.parametrize("backend,fused,ref_backend,ref_fused", RUNS)
@pytest.mark.parametrize("active_kind", ["random10", "all"])
def test_run_frontier_matches_reference(backend, fused, ref_backend,
                                        ref_fused, active_kind):
    """Whole frontier runs from a random start (not a fixed point, so the
    drain and the max_iters cut both show)."""
    rg = ref_gen.watts_strogatz(700, 8, 0.2, seed=4)
    max_iters = 25 if active_kind == "all" else 300
    rcfg = RefConfig(k=5, seed=6, max_iters=max_iters)
    cfg = SpinnerConfig(k=5, seed=6, max_iters=max_iters)
    active = _mask(active_kind, rg.num_vertices, rg.num_vertices, seed=3)
    labels, loads, key = ref_prepare_init(rg, rcfg)
    rstate, rhist = ref_engine.run_frontier(
        rg, rcfg, labels, loads, key, active,
        opts=RefOptions(score_backend=ref_backend, fused_update=ref_fused))
    g = graph_from_reference(rg)
    t_labels, t_loads, t_key = prepare_init(g, cfg, device="cpu")
    opts = EngineOptions(device="cpu", score_backend=backend,
                         fused_update=fused)
    state, scored = engine.run_frontier(g, cfg, t_labels, t_loads, t_key,
                                        active, opts)
    iters = int(rstate.iteration)
    np.testing.assert_array_equal(state.labels.numpy(),
                                  np.asarray(rstate.labels))
    np.testing.assert_array_equal(state.loads.numpy(),
                                  np.asarray(rstate.loads))
    assert int(state.iteration) == iters == len(scored)
    assert bool(state.halted) == bool(rstate.halted)
    assert scored == [float(x) for x in np.asarray(rhist)[:iters]]
    assert state.key == tuple(int(x) for x in np.asarray(rstate.key))
    assert float(state.total_messages) == float(rstate.total_messages)
    if active_kind == "random10":
        assert scored[0] == float(active.sum())


def test_frontier_runner_launches_nothing_after_the_drain(monkeypatch):
    """The loop reads the drained flag once per iteration: from a fixed
    point with a few active vertices, the step runs exactly
    ``iterations`` times and the run drains."""
    rg = ref_gen.clustered_graph(4, 150, p_in=0.2, p_out_edges_per_v=0.05,
                                 seed=2)
    g = graph_from_reference(rg)
    cfg = SpinnerConfig(k=4, seed=9, c=1.6)
    base = partition(g, cfg, engine="fused", record_history=False,
                     device="cpu")
    labels, loads, key = prepare_init(g, cfg, base.labels, device="cpu")
    calls = []
    real = engine.make_frontier_step

    def counting(cfg_, opts_):
        step = real(cfg_, opts_)

        def wrapped(*a):
            calls.append(1)
            return step(*a)
        return wrapped

    monkeypatch.setattr(engine, "make_frontier_step", counting)
    active = np.zeros(g.num_vertices, bool)
    active[::15] = True
    state, scored = engine.run_frontier(g, cfg, labels, loads, key, active,
                                        EngineOptions(device="cpu"))
    assert bool(state.halted)
    assert len(calls) == int(state.iteration) == len(scored) >= 1
    assert scored[0] == float(active.sum())


def test_frontier_wrapper_checks_the_mask(padded):
    g, num_real = padded
    csr = graph_from_reference(g).to_device("cpu")
    v, k = g.num_vertices, 4
    labels = torch.zeros(v, dtype=torch.int32)
    args = (labels, csr.row_ptr, csr.dst, csr.weight, csr.deg_w,
            torch.zeros(k), torch.zeros(v, k))
    before = fused_update_frontier.launches
    with pytest.raises(TypeError):
        fused_update_frontier(*args, torch.ones(v, dtype=torch.int32), k,
                              1e-6, True)
    with pytest.raises(ValueError):
        fused_update_frontier(*args, torch.ones(v - 1, dtype=torch.bool), k,
                              1e-6, True)
    with pytest.raises(TypeError):
        fused_update_frontier(*args, torch.ones(v, dtype=torch.bool), k,
                              1e-6, True, (csr.row_ptr.int(), csr.dst,
                                           csr.weight))
    fused_update_frontier(*args, torch.ones(v, dtype=torch.bool), k, 1e-6,
                          True)
    assert fused_update_frontier.launches == before     # CPU: plain version
