"""The on-device graph assembly equals the program's host build."""
import numpy as np
import pytest
import torch

from portbench import graphs
from portbench.graphs.assemble import assemble

from repro_torch.core.graph import from_edges

FIELDS = ("src", "dst", "weight", "row_ptr", "deg_w")


def _same(got: dict, want) -> None:
    for f in FIELDS:
        a, b = got[f], getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("spec", [
    {"generator": "watts_strogatz", "n": 900, "k_nbrs": 6, "beta": 0.3},
    {"generator": "watts_strogatz", "n": 400, "k_nbrs": 12, "beta": 1.0},
    {"generator": "chung_lu", "n": 1200, "pairs": 7000, "exponent": 2.1},
])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3])
def test_generators_assemble_as_from_edges(spec, seed):
    src, dst, n = graphs.generator(spec["generator"]).edges(spec, seed, "cpu")
    want = from_edges(src.numpy().astype(np.int32),
                      dst.numpy().astype(np.int32), n)
    got = graphs.build(spec, seed, "cpu")
    assert got["num_vertices"] == n
    _same(got, want)


def test_assemble_merges_pairs_and_drops_loops():
    src = torch.tensor([0, 1, 1, 2, 2, 3, 3, 0, 4, 4])
    dst = torch.tensor([1, 0, 0, 2, 3, 2, 0, 3, 1, 4])
    got = {k: v.numpy() for k, v in assemble(src, dst, 5).items()}
    _same(got, from_edges(src.numpy().astype(np.int32),
                          dst.numpy().astype(np.int32), 5))
    assert sorted(set(got["weight"].tolist())) == [1.0, 2.0]


def test_graph_is_a_function_of_its_seed():
    spec = {"generator": "chung_lu", "n": 500, "pairs": 3000, "exponent": 2.1}
    a, b = graphs.build(spec, 7, "cpu"), graphs.build(spec, 7, "cpu")
    c = graphs.build(spec, 8, "cpu")
    _same(a, type("G", (), b)())
    assert not np.array_equal(a["dst"], c["dst"])
