"""The PyTorch port's graph, generators and metrics against the reference.

Same generator seeds must give the same arrays; buckets, padded views and
metrics must match the reference's exactly, and ``Graph.to_device`` must
carry the padded CSR unchanged.
"""
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import generators as ref_gen
from repro.core import graph as ref_graph
from repro.core import metrics as ref_metrics
from repro_torch.convert import graph_from_reference
from repro_torch.core import engine, generators, graph, metrics

GRAPH_FIELDS = ("src", "dst", "weight", "row_ptr", "deg_w")


def _assert_same_graph(a, b):
    assert a.num_vertices == b.num_vertices
    for f in GRAPH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.total_weight == b.total_weight


@pytest.fixture(scope="module")
def port_graphs():
    return {
        "small_world": generators.watts_strogatz(3000, 10, 0.25, seed=7),
        "clustered": generators.clustered_graph(8, 250, p_in=0.05,
                                                p_out_edges_per_v=1.0,
                                                seed=5),
        "powerlaw": generators.powerlaw_ba(2000, 6, seed=9),
    }


@pytest.mark.parametrize("name", ["small_world", "clustered", "powerlaw"])
def test_generators_match_reference(name, port_graphs, request):
    _assert_same_graph(port_graphs[name], request.getfixturevalue(name))


def test_from_edges_directed_weights():
    src = np.array([0, 1, 1, 2, 2, 3, 3], np.int32)
    dst = np.array([1, 0, 2, 3, 3, 3, 0], np.int32)    # dup + self-loop
    for directed in (True, False):
        _assert_same_graph(graph.from_edges(src, dst, 5, directed),
                           ref_graph.from_edges(src, dst, 5, directed))


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 100, 1000, 4097,
                               4_000_000, 134_000_000])
def test_shape_bucket(n):
    for floor in (64, 128):
        assert graph.shape_bucket(n, floor) == ref_graph.shape_bucket(n,
                                                                      floor)


@pytest.mark.parametrize("name", ["small_world", "clustered", "powerlaw"])
def test_padded_view_matches_reference(name, request):
    rg = request.getfixturevalue(name)
    tg = graph_from_reference(rg)
    assert engine.graph_buckets(tg) == ref_engine.graph_buckets(rg)
    ref_pad, ref_real = ref_engine.padded_view(rg, ref_engine.EngineOptions())
    pad, real = engine.padded_view(tg, engine.EngineOptions(device="cpu"))
    assert real == ref_real
    _assert_same_graph(pad, ref_pad)
    # cached on the graph: the same view object comes back
    assert engine.padded_view(tg, engine.EngineOptions(device="cpu"))[0] \
        is pad
    same, _ = engine.padded_view(tg, engine.EngineOptions(device="cpu",
                                                          pad="none"))
    assert same is tg


def test_pad_graph_parks_on_last_vertex_at_bucket():
    g = ref_gen.watts_strogatz(64, 4, 0.1, seed=1)
    tg = graph_from_reference(g)
    e = g.num_directed_entries + 7
    _assert_same_graph(graph.pad_graph(tg, 64, e),
                       ref_graph.pad_graph(g, 64, e))
    with pytest.raises(ValueError):
        graph.pad_graph(tg, 10, e)


def test_to_device_uploads_csr_once(small_world):
    tg = graph_from_reference(small_world)
    csr = tg.to_device("cpu")
    assert tg.to_device("cpu") is csr
    assert csr.row_ptr.dtype == torch.int64
    assert csr.src.dtype == csr.dst.dtype == torch.int32
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(csr, f).numpy(),
                                      getattr(small_world, f))


@pytest.mark.parametrize("name", ["small_world", "clustered", "powerlaw"])
def test_metrics_match_reference(name, request):
    rg = request.getfixturevalue(name)
    tg = graph_from_reference(rg)
    labels = np.random.default_rng(3).integers(0, 7, rg.num_vertices)
    assert metrics.summarize(tg, labels, 7) == ref_metrics.summarize(
        rg, labels, 7)
    np.testing.assert_array_equal(metrics.loads(tg, labels, 7),
                                  ref_metrics.loads(rg, labels, 7))
