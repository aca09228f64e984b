"""The port's application engine against the reference, on the CPU.

``repro_torch.apps.run_app`` on one device against ``repro.apps.run_app``
(XLA scatter and Pallas-interpret combine) on the same graph and labels:
values and supersteps identical for WCC/BFS/SSSP, PageRank within the
reference's own tolerance (rtol 1e-4, atol 1e-9: float32 sums in another
order), and the accounting fields equal.  Also the numpy oracles, the
placement invariance the Spinner-vs-hash comparison rests on, and labels
carried over from a reference partition.
"""
import numpy as np
import pytest
import torch

from repro.apps import run_app as ref_run_app
from repro.core import generators as ref_gen
from repro.core import pregel as ref_pregel
from repro.core.spinner import SpinnerConfig as RefConfig
from repro.core.spinner import partition as ref_partition
from repro_torch.apps import APPS, AppState, run_app
from repro_torch.convert import graph_from_reference
from repro_torch.core import pregel
from repro_torch.kernels.pregel_combine import pregel_combine, pregel_reduce

WORKLOADS = ["pagerank", "wcc", "bfs", "sssp"]
K = 4


def hash_labels(v: int, k: int) -> np.ndarray:
    return (np.arange(v) * np.int64(2654435761) % k).astype(np.int32)


@pytest.fixture(scope="module")
def apps_graph():
    return ref_gen.clustered_graph(4, 200, p_in=0.05, p_out_edges_per_v=1.0,
                                   seed=5)


@pytest.fixture(scope="module")
def spinner_labels(apps_graph):
    return ref_partition(apps_graph, RefConfig(k=K, seed=1, max_iters=80),
                         record_history=False).labels


def assert_same_run(got, want):
    """Values and supersteps identical for the min workloads, PageRank
    within tolerance; every accounting field equal."""
    assert got.workload == want.workload
    assert got.supersteps == want.supersteps
    assert got.converged == want.converged
    if got.workload == "pagerank":
        np.testing.assert_allclose(got.values, want.values, rtol=1e-4,
                                   atol=1e-9)
    else:
        assert got.values.dtype == want.values.dtype
        np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.device_messages, want.device_messages)
    assert got.straggler_skew == want.straggler_skew
    np.testing.assert_array_equal(got.edge_counts, want.edge_counts)
    assert got.wire_bytes == want.wire_bytes == 0.0
    assert got.wire_bytes_per_step == 0.0
    assert (got.ndev, got.plan) == (1, "none")


@pytest.mark.parametrize("combine", ["xla", "pallas"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_app_matches_reference(apps_graph, spinner_labels, workload,
                                   combine):
    want = ref_run_app(apps_graph, spinner_labels, workload,
                       combine=combine)
    g = graph_from_reference(apps_graph)
    for backend in ("cuda", "torch"):
        got = run_app(g, spinner_labels, workload, combine=backend,
                      device="cpu")
        assert_same_run(got, want)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_app_matches_reference_on_a_small_world(workload):
    """A second graph, hash-placed, with a non-default source and
    iteration counts (and a BFS cap that stops before the halt)."""
    rg = ref_gen.watts_strogatz(3000, 10, 0.25, seed=7)
    labels = hash_labels(rg.num_vertices, 8)
    kw = dict(iters=7, max_steps=3, source=17, damping=0.9)
    want = ref_run_app(rg, labels, workload, **kw)
    got = run_app(graph_from_reference(rg), labels, workload, device="cpu",
                  **kw)
    assert_same_run(got, want)
    assert got.supersteps == (7 if workload == "pagerank" else 3)
    assert got.converged == (workload == "pagerank")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_app_matches_oracles(apps_graph, spinner_labels, workload):
    g = graph_from_reference(apps_graph)
    res = run_app(g, spinner_labels, workload, device="cpu")
    if workload == "pagerank":
        want = pregel.pagerank(g, spinner_labels, K)
        np.testing.assert_allclose(res.values, want.values, rtol=1e-4,
                                   atol=1e-9)
    elif workload == "wcc":
        want = pregel.wcc(g, spinner_labels, K)
        np.testing.assert_array_equal(res.values, want.values)
    else:
        want = pregel.sssp(g, 0, spinner_labels, K)
        np.testing.assert_array_equal(res.values, want.values)
    assert res.supersteps == want.supersteps
    # every message the oracle counts was combined by the one device
    assert res.device_messages[0] == want.total_messages()


def test_placement_invariance(apps_graph, spinner_labels):
    """WCC seeds components with ORIGINAL ids, so values are the same
    under any placement; BFS too; PageRank within tolerance."""
    g = graph_from_reference(apps_graph)
    hashed = hash_labels(g.num_vertices, K)
    for workload in WORKLOADS:
        a = run_app(g, spinner_labels, workload, device="cpu")
        b = run_app(g, hashed, workload, device="cpu")
        assert a.supersteps == b.supersteps
        np.testing.assert_array_equal(a.device_messages, b.device_messages)
        if workload == "pagerank":
            np.testing.assert_allclose(a.values, b.values, rtol=1e-4,
                                       atol=1e-9)
        else:
            np.testing.assert_array_equal(a.values, b.values)


def test_oracles_match_reference(apps_graph, spinner_labels):
    g = graph_from_reference(apps_graph)
    hashed = hash_labels(g.num_vertices, K)
    pairs = [(pregel.pagerank(g, spinner_labels, K, iters=5),
              ref_pregel.pagerank(apps_graph, spinner_labels, K, iters=5)),
             (pregel.sssp(g, 3, spinner_labels, K),
              ref_pregel.sssp(apps_graph, 3, spinner_labels, K)),
             (pregel.wcc(g, spinner_labels, K),
              ref_pregel.wcc(apps_graph, spinner_labels, K))]
    for got, want in pairs:
        np.testing.assert_array_equal(got.values, want.values)
        assert got.supersteps == want.supersteps
        assert got.total_messages() == want.total_messages()
        assert got.total_remote() == want.total_remote()
        assert got.simulated_runtime() == want.simulated_runtime()
        for a, b in zip(got.stats, want.stats):
            np.testing.assert_array_equal(a.per_partition_msgs,
                                          b.per_partition_msgs)
    for app in ("pagerank", "sssp", "wcc"):
        assert pregel.compare_partitionings(g, K, hashed, spinner_labels,
                                            app=app) == \
            ref_pregel.compare_partitionings(apps_graph, K, hashed,
                                             spinner_labels, app=app)


def test_reference_labels_carry_across():
    """A reference partition's labels feed the port's run_app directly."""
    rg = ref_gen.powerlaw_ba(600, 4, seed=3)
    labels = ref_partition(rg, RefConfig(k=8, seed=2),
                           record_history=False).labels
    g = graph_from_reference(rg)
    for workload in ("pagerank", "wcc", "bfs"):
        assert_same_run(run_app(g, labels, workload, device="cpu"),
                        ref_run_app(rg, labels, workload))


def test_cpu_runs_launch_no_kernel(apps_graph, spinner_labels):
    g = graph_from_reference(apps_graph)
    before = (pregel_reduce.launches, pregel_combine.launches)
    run_app(g, spinner_labels, "bfs", device="cpu")
    assert (pregel_reduce.launches, pregel_combine.launches) == before


def test_no_card_raises_instead_of_falling_back(apps_graph, spinner_labels,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graph_from_reference(apps_graph)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_app(g, spinner_labels, "wcc", device=device)


def test_run_app_validates_arguments(apps_graph, spinner_labels):
    g = graph_from_reference(apps_graph)
    with pytest.raises(ValueError, match="unknown workload"):
        run_app(g, spinner_labels, "triangles", device="cpu")
    with pytest.raises(ValueError, match="unknown combine"):
        run_app(g, spinner_labels, "wcc", combine="pallas", device="cpu")
    with pytest.raises(ValueError, match="source"):
        run_app(g, spinner_labels, "bfs", source=g.num_vertices,
                device="cpu")
    with pytest.raises(ValueError, match="labels cover"):
        run_app(g, spinner_labels[:-1], "wcc", device="cpu")
    assert sorted(APPS) == sorted(WORKLOADS)
    assert AppState._fields == ("values", "changed", "step", "active",
                                "msgs")
