"""The plain reference equals the program at tiny sizes on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import graphs
from portbench.reference import spinner as ref
from portbench.reference import threefry

from repro_torch import rng
from repro_torch.core import EngineOptions, SpinnerConfig, partition
from repro_torch.core.graph import Graph, add_edges, shape_bucket
from repro_torch.core.session import PartitionSession

SPECS = {"ws": {"generator": "watts_strogatz", "n": 1200, "k_nbrs": 6,
                "beta": 0.3},
         "cl": {"generator": "chung_lu", "n": 1500, "pairs": 7000,
                "exponent": 2.1}}
PARAMS = ref.Params(k=8)


def _graph(name, seed=3):
    g = graphs.build(SPECS[name], seed, "cpu")
    return g, Graph(num_vertices=g["num_vertices"], src=g["src"],
                    dst=g["dst"], weight=g["weight"], row_ptr=g["row_ptr"],
                    deg_w=g["deg_w"])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 1])
def test_threefry_copy_draws_the_program_streams(seed):
    key = threefry.seed_key(seed)
    assert key == rng.PRNGKey(seed)
    assert list(threefry.split(key)) == list(rng.split(key))
    k1 = threefry.split(key)[1]
    np.testing.assert_array_equal(
        threefry.uniform(k1, 5000, 1e-7, "cpu").numpy(),
        rng.uniform(k1, (5000,), 0.0, 1e-7, device="cpu").numpy())
    np.testing.assert_array_equal(
        threefry.uniform(k1, 777, 1.0, "cpu").numpy(),
        rng.uniform(k1, (777,), device="cpu").numpy())


@pytest.mark.parametrize("n", [1, 64, 65, 1000, 4_847_571, 127_999_752])
def test_shape_bucket_as_the_program_pads(n):
    assert ref.shape_bucket(n) == shape_bucket(n, 64)


@pytest.mark.parametrize("name", ["ws", "cl"])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_partition_equals_the_program(name, seed):
    g, graph = _graph(name)
    init = np.random.default_rng(seed).integers(0, PARAMS.k, g["num_vertices"],
                                                dtype=np.int32)
    cfg = SpinnerConfig(k=PARAMS.k, seed=seed)
    got = partition(graph, cfg, init=init,
                    options=EngineOptions(engine="fused", device="cpu"))
    edges = ref.host_edges(g, "cpu")
    want = ref.run(edges, PARAMS, torch.from_numpy(init),
                   ref.capacity(PARAMS, ref.float32_total(g["deg_w"])), seed)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.loads, want.loads)
    assert (got.iterations, got.halted) == (want.iterations, want.halted)


def test_pair_ledger_is_the_add_edges_chain():
    g, graph = _graph("ws")
    n = g["num_vertices"]
    rs = np.random.default_rng(4)
    s0, d0 = rs.integers(0, n, 40), rs.integers(0, n, 40)
    # a later batch repeats pairs both ways, and a base pair's reverse
    batches = [(s0, d0), (d0[:20], s0[:20]), (s0[20:], d0[20:]),
               (g["dst"][:15], g["src"][:15]), (rs.integers(0, n, 30),
                                                rs.integers(0, n, 30))]
    edges = ref.host_edges(g, "cpu")
    ledger = ref.PairLedger(edges.src, edges.dst, edges.w, n)
    chain = graph
    for s, d in batches:
        ledger.add(torch.from_numpy(np.asarray(s)), torch.from_numpy(
            np.asarray(d)))
        chain = add_edges(chain, np.asarray(s, np.int32),
                          np.asarray(d, np.int32))
        merged = ledger.edges()
        key = lambda a, b: np.sort(a.numpy() * n + b.numpy())   # noqa: E731
        np.testing.assert_array_equal(key(merged.src, merged.dst),
                                      key(torch.from_numpy(chain.src),
                                          torch.from_numpy(chain.dst)))
        np.testing.assert_array_equal(merged.deg[:n].numpy(), chain.deg_w)
        assert ledger.total_weight(0.0) + float(graph.deg_w.sum()) \
            == float(chain.deg_w.astype(np.float64).sum())


def test_adapt_chain_equals_the_program():
    g, graph = _graph("cl")
    n, seed = g["num_vertices"], 99
    cfg = SpinnerConfig(k=PARAMS.k, seed=seed)
    s = PartitionSession(graph, cfg, EngineOptions(engine="fused",
                                                   device="cpu"))
    init = np.random.default_rng(1).integers(0, PARAMS.k, n, dtype=np.int32)
    prev = s.partition(init=init).labels
    edges = ref.host_edges(g, "cpu")
    base = ref.float32_total(g["deg_w"])
    ledger = ref.PairLedger(edges.src, edges.dst, edges.w, n)
    rs = np.random.default_rng(2)
    for _ in range(4):
        src = rs.integers(0, n, 25).astype(np.int32)
        dst = rs.integers(0, n, 25).astype(np.int32)
        got = s.adapt(edge_updates=(src, dst))
        ledger.add(torch.from_numpy(src), torch.from_numpy(dst))
        want = ref.run(ledger.edges(), PARAMS, torch.from_numpy(prev),
                       ref.capacity(PARAMS, ledger.total_weight(base)), seed)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.loads, want.loads)
        assert got.iterations == want.iterations
        prev = got.labels
    st = s.stats()["delta"]
    assert st["fallback_adapts"] == 0
    assert st["tracked_total_weight"] == ledger.total_weight(base)


def test_bfloat16_reference_departs():
    g, _ = _graph("ws")
    init = torch.from_numpy(np.random.default_rng(5).integers(
        0, PARAMS.k, g["num_vertices"], dtype=np.int32))
    edges = ref.host_edges(g, "cpu")
    c = ref.capacity(PARAMS, ref.float32_total(g["deg_w"]))
    a = ref.run(edges, PARAMS, init, c, 3)
    b = ref.run(edges, PARAMS, init, c, 3, dtype=torch.bfloat16)
    assert np.count_nonzero(a.labels != b.labels) > len(init) // 10


def test_max_iters_bounds_the_run():
    g, _ = _graph("ws")
    edges = ref.host_edges(g, "cpu")
    init = torch.zeros(g["num_vertices"], dtype=torch.int32)
    out = ref.run(edges, dataclasses.replace(PARAMS, max_iters=3), init,
                  ref.capacity(PARAMS, ref.float32_total(g["deg_w"])), 1)
    assert out.iterations == 3 and not out.halted
