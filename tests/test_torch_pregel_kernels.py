"""The Pregel combine path of the port against the reference, on the CPU.

The placed layout's arrays must equal the reference's ``AppLayout``; the
plain reduce and combine (``repro_torch.kernels.ref``, which the CUDA
kernels are held to on the card) must match the reference's XLA scatter
combine and its Pallas pair (interpret mode) on the same inputs: bitwise
for the min workloads, within float32 tolerance for PageRank's sum
(another summation order).  Inputs come from a numpy seed.
"""
import ast
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import APPS as REF_APPS
from repro.apps import build_app_layout as ref_build_app_layout
from repro.apps import engine as ref_app_engine
from repro.core import comm
from repro.core import generators as ref_gen
from repro.core.spinner import SpinnerConfig as RefConfig
from repro.core.spinner import partition as ref_partition
from repro.kernels.pregel_combine import (INF_I32, combine_tiles_finish,
                                          combine_tiles_interior)
from repro_torch.apps import build_app_layout
from repro_torch.convert import graph_from_reference
from repro_torch.kernels import _build, ref
from repro_torch.kernels import pregel_combine as wrappers
from repro_torch.kernels.pregel_combine import pregel_combine, pregel_reduce

DAMPING = 0.85
TILE = 128
# (workload, combine, update, bias)
CASES = [("pagerank", "sum", "pagerank", 0), ("wcc", "min", "min", 0),
         ("bfs", "min", "min", 1)]


def hash_labels(v: int, k: int) -> np.ndarray:
    return (np.arange(v) * np.int64(2654435761) % k).astype(np.int32)


@pytest.fixture(scope="module")
def apps_graph():
    return ref_gen.clustered_graph(4, 200, p_in=0.05, p_out_edges_per_v=1.0,
                                   seed=5)


@pytest.fixture(scope="module")
def placements(apps_graph):
    """(name, graph, labels): Spinner and hash placements of the clustered
    graph, and a seeded random one of a small world."""
    spinner = ref_partition(apps_graph, RefConfig(k=4, seed=1, max_iters=80),
                            record_history=False).labels
    ws = ref_gen.watts_strogatz(3000, 10, 0.25, seed=7)
    rand = np.random.default_rng(3).integers(0, 8, 3000).astype(np.int32)
    return {"spinner": (apps_graph, spinner),
            "hash": (apps_graph, hash_labels(apps_graph.num_vertices, 4)),
            "ws_random": (ws, rand)}


@pytest.fixture(scope="module")
def layouts(placements):
    """name -> (reference AppLayout, port AppLayout on the CPU)."""
    return {name: (ref_build_app_layout(g, lab, 1),
                   build_app_layout(graph_from_reference(g), lab, "cpu"))
            for name, (g, lab) in placements.items()}


def _inputs(layout, combine: str, seed: int) -> tuple:
    """(send, values, acc_init) over the padded vertex set, from a seed:
    random message values with unreached (INF) entries for the min."""
    gen = np.random.default_rng(seed)
    v_pad = layout.v_pad
    if combine == "sum":
        send = gen.uniform(0.0, 1e-3, v_pad).astype(np.float32)
        values = gen.uniform(0.0, 1e-3, v_pad).astype(np.float32)
        init = gen.uniform(0.0, 1e-3, v_pad).astype(np.float32)
    else:
        send = gen.integers(0, layout.num_real, v_pad).astype(np.int32)
        send[gen.random(v_pad) < 0.3] = INF_I32
        values = gen.integers(0, layout.num_real, v_pad).astype(np.int32)
        values[gen.random(v_pad) < 0.3] = INF_I32
        init = gen.integers(0, layout.num_real, v_pad).astype(np.int32)
    return send, values, init


def _assert_close(got: torch.Tensor, want, combine: str, rtol: float):
    want = np.asarray(want)
    if combine == "min":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-9)


@pytest.mark.parametrize("name", ["spinner", "hash", "ws_random"])
def test_layout_arrays_match_reference(layouts, name):
    want, got = layouts[name]
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.v_pad == want.v_pad and got.num_real == want.num_real
    np.testing.assert_array_equal(got.row_ptr.numpy(), want.pgraph.row_ptr)
    np.testing.assert_array_equal(got.dst.numpy(), want.pgraph.dst)
    np.testing.assert_array_equal(got.deg_cnt.numpy(),
                                  want.deg_cnt.reshape(-1))
    np.testing.assert_array_equal(got.edge_counts, want.edge_counts)
    # one device: every edge interior, the frontier CSR empty
    assert want.sg.frontier_counts.sum() == 0
    assert got.frontier_dst.numel() == 0
    assert not got.frontier_row_ptr.any()
    np.testing.assert_array_equal(
        got.valid.numpy(), np.arange(got.v_pad) < want.counts[0])
    placed = np.zeros(got.v_pad, np.int64)
    placed[got.perm] = np.arange(got.num_real)
    np.testing.assert_array_equal(got.unpermute(placed),
                                  np.arange(got.num_real))


def test_layout_is_cached_and_validated(placements):
    g, lab = placements["spinner"]
    pg = graph_from_reference(g)
    assert build_app_layout(pg, lab, "cpu") is build_app_layout(pg, lab,
                                                                "cpu")
    with pytest.raises(ValueError, match="labels cover"):
        build_app_layout(pg, lab[:-1], "cpu")
    padded = pg.__class__(num_vertices=pg.num_vertices, src=pg.src,
                          dst=pg.dst, weight=np.zeros_like(pg.weight),
                          row_ptr=pg.row_ptr, deg_w=pg.deg_w)
    with pytest.raises(ValueError, match="weight-0"):
        build_app_layout(padded, lab, "cpu")


@pytest.mark.parametrize("name", ["spinner", "ws_random"])
@pytest.mark.parametrize("workload,combine,update,bias", CASES)
def test_plain_pair_matches_xla_combine(layouts, name, workload, combine,
                                        update, bias):
    """The plain reduce and combine against the reference's XLA scatter
    pair (``_make_combine(..., "xla")``) on the same message vector."""
    rl, pl = layouts[name]
    spec = REF_APPS[workload]
    plan = comm.make_exchange_plan("allgather", rl.sg, pad=True)
    args = ref_app_engine._xla_app_args(rl.sg, plan)
    blocks = tuple(a[0] for a in args)            # strip the shard dim
    interior, finish = ref_app_engine._make_combine(
        spec, "xla", rl.v_pad, DAMPING, 0, False)
    send, values, _ = _inputs(rl, combine, seed=len(name) + bias)
    base = np.float32((1.0 - DAMPING) / rl.num_real)
    valid = np.arange(rl.v_pad) < rl.num_real
    want_partial = interior(jnp.asarray(send), *blocks)
    want_new, want_chg = finish(want_partial, jnp.asarray(send),
                                jnp.asarray(values), jnp.asarray(valid),
                                jnp.float32(base), *blocks)

    t = torch.from_numpy
    partial = ref.pregel_reduce_ref(t(send), pl.row_ptr, pl.dst,
                                    combine=combine, bias=bias)
    _assert_close(partial, want_partial, combine, rtol=1e-5)
    new, chg = ref.pregel_combine_ref(
        t(send), pl.frontier_row_ptr, pl.frontier_dst, t(values), pl.valid,
        float(base), combine=combine, update=update, damping=DAMPING,
        bias=bias, acc_init=partial)
    _assert_close(new, want_new, combine, rtol=1e-5)
    np.testing.assert_array_equal(chg.numpy(), np.asarray(want_chg))


@pytest.mark.parametrize("workload,combine,update,bias", CASES)
def test_plain_pair_matches_pallas_pair(layouts, workload, combine, update,
                                        bias):
    """``pregel_reduce_ref`` -> ``pregel_combine_ref`` against the Pallas
    ``combine_tiles_interior`` -> ``combine_tiles_finish`` (interpret
    mode), built as the reference engine builds them; vertex order."""
    rl, pl = layouts["spinner"]
    plan = comm.make_exchange_plan("allgather", rl.sg, pad=True)
    si, ii, wmi, sf, fi, wmf, perm, inv_perm = (
        a[0] for a in ref_app_engine._pallas_app_args(rl.sg, plan, TILE,
                                                      TILE))
    send, values, _ = _inputs(rl, combine, seed=11 + bias)
    base = np.float32((1.0 - DAMPING) / rl.num_real)
    valid = np.arange(rl.v_pad) < rl.num_real
    partial_t = combine_tiles_interior(jnp.asarray(send), si, ii, wmi,
                                       tile_v=TILE, combine=combine,
                                       bias=bias, interpret=True)
    want_new, want_chg = combine_tiles_finish(
        partial_t, jnp.asarray(send), jnp.asarray(values),
        jnp.asarray(valid), jnp.float32(base), sf, fi, wmf, perm, inv_perm,
        tile_v=TILE, combine=combine, update=update, damping=DAMPING,
        bias=bias, interpret=True)

    t = torch.from_numpy
    partial = ref.pregel_reduce_ref(t(send), pl.row_ptr, pl.dst,
                                    combine=combine, bias=bias)
    _assert_close(partial, np.asarray(partial_t).reshape(-1)[np.asarray(perm)],
                  combine, rtol=1e-5)
    new, chg = ref.pregel_combine_ref(
        t(send), pl.frontier_row_ptr, pl.frontier_dst, t(values), pl.valid,
        float(base), combine=combine, update=update, damping=DAMPING,
        bias=bias, acc_init=partial)
    _assert_close(new, want_new, combine, rtol=1e-5)
    np.testing.assert_array_equal(chg.numpy(), np.asarray(want_chg))


@pytest.mark.parametrize("workload,combine,update,bias", CASES)
def test_acc_init_seeds_the_fold(layouts, workload, combine, update, bias):
    """A seeded reduce folds the seed with the row's messages; the combine
    over the FULL CSR seeded by a partial equals the one over the empty
    frontier seeded by the full partial (the one-device schedule)."""
    _, pl = layouts["ws_random"]
    send, values, init = (torch.from_numpy(a)
                          for a in _inputs(pl, combine, seed=5))
    plain = ref.pregel_reduce_ref(send, pl.row_ptr, pl.dst, combine=combine,
                                  bias=bias)
    seeded = ref.pregel_reduce_ref(send, pl.row_ptr, pl.dst, combine=combine,
                                   bias=bias, acc_init=init)
    want = plain + init if combine == "sum" else torch.minimum(plain, init)
    _assert_close(seeded, want.numpy(), combine, rtol=1e-6)
    base = float(np.float32((1.0 - DAMPING) / pl.num_real))
    kw = dict(combine=combine, update=update, damping=DAMPING, bias=bias)
    full = ref.pregel_combine_ref(send, pl.row_ptr, pl.dst, values,
                                  pl.valid, base, acc_init=init, **kw)
    split = ref.pregel_combine_ref(send, pl.frontier_row_ptr,
                                   pl.frontier_dst, values, pl.valid, base,
                                   acc_init=seeded, **kw)
    _assert_close(full[0], split[0].numpy(), combine, rtol=1e-6)
    assert torch.equal(full[1], split[1])
    if combine == "min":    # pads keep their value and never change
        pads = ~pl.valid
        assert torch.equal(full[0][pads], values[pads])
        assert not full[1][pads].any()


def test_wrappers_run_the_plain_versions_on_cpu(layouts):
    """CPU tensors go to the plain versions and never count a launch."""
    _, pl = layouts["spinner"]
    send, values, init = (torch.from_numpy(a)
                          for a in _inputs(pl, "min", seed=2))
    before = (pregel_reduce.launches, pregel_combine.launches)
    got = pregel_reduce(send, pl.row_ptr, pl.dst, combine="min", bias=1,
                        acc_init=init)
    want = ref.pregel_reduce_ref(send, pl.row_ptr, pl.dst, combine="min",
                                 bias=1, acc_init=init)
    assert torch.equal(got, want)
    got = pregel_combine(send, pl.row_ptr, pl.dst, values, pl.valid, 0.0,
                         combine="min", update="min", damping=DAMPING,
                         bias=1, acc_init=init)
    want = ref.pregel_combine_ref(send, pl.row_ptr, pl.dst, values,
                                  pl.valid, 0.0, combine="min",
                                  update="min", damping=DAMPING, bias=1,
                                  acc_init=init)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (pregel_reduce.launches, pregel_combine.launches) == before


def test_wrappers_validate_inputs(layouts):
    _, pl = layouts["spinner"]
    send_f = torch.zeros(pl.v_pad)
    send_i = torch.zeros(pl.v_pad, dtype=torch.int32)
    rp, dst = pl.row_ptr, pl.dst
    with pytest.raises(TypeError):
        pregel_reduce(send_i, rp, dst, combine="sum")
    with pytest.raises(TypeError):
        pregel_reduce(send_f, rp.int(), dst, combine="sum")
    with pytest.raises(ValueError, match="no bias"):
        pregel_reduce(send_f, rp, dst, combine="sum", bias=1)
    with pytest.raises(ValueError, match="unknown combine"):
        pregel_reduce(send_f, rp, dst, combine="max")
    with pytest.raises(ValueError):
        pregel_reduce(send_f, rp, dst, combine="sum",
                      acc_init=torch.zeros(pl.v_pad - 1))
    with pytest.raises(ValueError, match="contiguous"):
        pregel_reduce(torch.zeros(2 * pl.v_pad)[::2], rp, dst,
                      combine="sum")
    kw = dict(combine="sum", update="pagerank", damping=DAMPING)
    with pytest.raises(ValueError, match="takes no update"):
        pregel_combine(send_f, rp, dst, send_f, pl.valid, 0.0,
                       combine="sum", update="min", damping=DAMPING)
    with pytest.raises(ValueError, match="float32 value"):
        pregel_combine(send_f, rp, dst, send_f, pl.valid, 0.1, **kw)
    with pytest.raises(TypeError):
        pregel_combine(send_f, rp, dst, send_f, pl.valid.int(), 0.0, **kw)
    with pytest.raises(ValueError):
        pregel_combine(send_f, rp, dst, send_f[:-1], pl.valid, 0.0, **kw)
    with pytest.raises(ValueError, match="takes no update"):
        ref.pregel_combine_ref(send_f, rp, dst, send_f, pl.valid, 0.0,
                               combine="min", update="pagerank",
                               damping=DAMPING)


def test_wrappers_have_no_fallback():
    """A CUDA tensor launches the kernel or raises: no ``try`` in the
    wrappers or the build; the kernel source and its header are there."""
    for module in (wrappers, _build):
        tree = ast.parse(inspect.getsource(module))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], \
            module.__name__
    assert "pregel_combine" in _build.SOURCES
    csrc = Path(wrappers.__file__).with_name("csrc")
    text = csrc.joinpath("pregel_combine.cu").read_text()
    for fn in wrappers._SIGNATURES:
        assert f'extern "C" int {fn}(' in text, fn
    # the kernel's min identity is the plain version's INF_I32
    assert ref.INF_I32 == INF_I32 == 2 ** 30
    assert "kInfI32 = 1 << 30" in text
    assert csrc.joinpath("csr_launch.cuh").exists()


def test_library_path_covers_the_shared_header(tmp_path, monkeypatch):
    """Editing the shared header changes every source's library name, so
    a stale build is never loaded."""
    for name in _build.SOURCES:
        (tmp_path / f"{name}.cu").write_text(f"// {name}\n")
    header = tmp_path / "csr_launch.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header.write_text("// two\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
