"""The placement layer, ``partitioning_difference`` and the grid and
Erdos-Renyi generators of the port against the reference, on the CPU.

Graph arrays and metrics are numpy on both sides and must be equal; the
placement runs (``device="cpu"``: the CUDA backend's plain versions) must
give the reference's labels and stats exactly.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import generators as ref_gen
from repro.core import metrics as ref_metrics
from repro.core import placement as ref_place
from repro_torch.core import generators, metrics, placement


def _same_graph(got, want):
    for f in dataclasses.fields(want):
        if f.name.startswith("_"):
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 7), (9, 13), (40, 25)])
def test_grid_2d_matches_reference(rows, cols):
    _same_graph(generators.grid_2d(rows, cols), ref_gen.grid_2d(rows, cols))


@pytest.mark.parametrize("n,avg_deg,seed", [(10, 0.0, 0), (500, 6.0, 3),
                                            (3000, 2.5, 7)])
def test_erdos_renyi_matches_reference(n, avg_deg, seed):
    _same_graph(generators.erdos_renyi(n, avg_deg, seed=seed),
                ref_gen.erdos_renyi(n, avg_deg, seed=seed))


def test_partitioning_difference_matches_reference():
    gen = np.random.default_rng(2)
    for n in (0, 1, 17, 1000):
        a = gen.integers(0, 4, n)
        b = np.where(gen.random(n) < 0.3, gen.integers(0, 4, n), a)
        assert metrics.partitioning_difference(a, b) \
            == ref_metrics.partitioning_difference(a, b)
    with pytest.raises(ValueError, match="shape"):
        metrics.partitioning_difference(np.zeros(3), np.zeros(4))


def _choices(n_tokens: int, n_experts: int, top_k: int, seed: int):
    gen = np.random.default_rng(seed)
    return gen.integers(0, n_experts, (n_tokens, top_k))


@pytest.mark.parametrize("top_k,max_edges", [(2, 2_000_000), (3, 500)])
def test_coactivation_graph_and_cross_shard_mass(top_k, max_edges):
    choices = _choices(2000, 64, top_k, seed=5)
    _same_graph(placement.coactivation_graph(choices, 64, max_edges),
                ref_place.coactivation_graph(choices, 64, max_edges))
    assign = np.random.default_rng(1).integers(0, 8, 64)
    assert placement.cross_shard_mass(choices, assign) \
        == ref_place.cross_shard_mass(choices, assign)


def test_place_experts_matches_reference():
    """A cold placement, then an incremental re-placement from it after a
    routing drift (the session path): labels and stats equal."""
    choices = _choices(3000, 64, 2, seed=0)
    got = placement.place_experts(choices, 64, 8, seed=0, device="cpu")
    want = ref_place.place_experts(choices, 64, 8, seed=0)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == want[1]
    drift = np.concatenate([choices[500:], _choices(500, 64, 2, seed=9)])
    got2 = placement.place_experts(drift, 64, 8, seed=1, prev=got[0],
                                   device="cpu")
    want2 = ref_place.place_experts(drift, 64, 8, seed=1, prev=want[0])
    np.testing.assert_array_equal(got2[0], np.asarray(want2[0]))
    assert got2[1] == want2[1]
    assert got2[1]["moved_from_prev"] is not None


def test_expert_placement_case_matches_reference():
    """The reference's defaults but for the token count (the card's phase
    (j3) runs the full 20,000)."""
    g, labels, stats = placement.expert_placement_case(n_tokens=4000,
                                                       device="cpu")
    rg, rlabels, rstats = ref_place.expert_placement_case(n_tokens=4000)
    _same_graph(g, rg)
    np.testing.assert_array_equal(labels, np.asarray(rlabels))
    assert stats == rstats


@pytest.mark.parametrize("n,stages", [(24, 4), (61, 8)])
def test_place_pipeline_stages_matches_reference(n, stages):
    costs = np.random.default_rng(n).random(n) + 0.5
    got = placement.place_pipeline_stages(costs, stages, seed=3,
                                          device="cpu")
    want = ref_place.place_pipeline_stages(costs, stages, seed=3)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == want[1]
