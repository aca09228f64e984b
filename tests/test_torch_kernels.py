"""The CSR kernels' plain versions against the reference's Pallas kernels,
and the wrappers' dispatch rules.

Inputs are made from a numpy seed and handed to both sides.  The Pallas
kernels run in interpret mode, as the reference's own tests run them on
the CPU.  Every comparison is bitwise: the score sums are exact integers
in float32 and the epilogue keeps the reference's op order.

The kernels themselves are held to these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import ast
import functools
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import generators as ref_gen
from repro.core.graph import build_tiled_csr
from repro.kernels import ops as ref_ops
from repro.kernels.spinner_scores import fused_update_from_tiles
from repro_torch.convert import graph_from_reference
from repro_torch.kernels import ref, spinner_scores as wrappers
from repro_torch.kernels.spinner_scores import fused_update, spinner_scores

KS = [2, 7, 32, 130]


@pytest.fixture(scope="module")
def padded():
    """A hub-heavy graph on its bucketed layout (weight-0 pad entries)."""
    g = ref_gen.powerlaw_ba(400, 5, seed=2)
    pad, real = ref_engine.padded_view(g, ref_engine.EngineOptions())
    return pad, real


def _inputs(graph, k, seed):
    gen = np.random.default_rng(seed)
    v = graph.num_vertices
    labels = gen.integers(0, k, v).astype(np.int32)
    noise = (gen.random((v, k)) * 1e-7).astype(np.float32)
    # loads near capacity so penalties are O(1), as in a run
    pen = gen.uniform(0.8, 1.2, k).astype(np.float32)
    return labels, noise, pen


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("k", KS)
def test_scores_ref_matches_pallas(padded, k):
    g, _ = padded
    labels, _, _ = _inputs(g, k, seed=k)
    tiled = build_tiled_csr(g, tile_v=128, tile_e=128)
    want = ref_ops.spinner_scores_tiled(jnp.asarray(labels), tiled=tiled,
                                        k=k, interpret=True)
    tg = graph_from_reference(g)
    csr = tg.to_device("cpu")
    got = ref.spinner_scores_ref(torch.from_numpy(labels), csr.src, csr.dst,
                                 csr.weight, g.num_vertices, k)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the wrapper on CPU tensors is the plain version, from the CSR
    via_wrapper = spinner_scores(torch.from_numpy(labels), csr.row_ptr,
                                 csr.dst, csr.weight, k)
    np.testing.assert_array_equal(_bits(via_wrapper.numpy()), _bits(want))


@functools.partial(jax.jit, static_argnames=("k", "k_pad", "weighted"))
def _pallas_fused(labels, deg_t, noise, valid, pen, src_local, dst, w, perm,
                  inv_perm, *, k, k_pad, weighted):
    return fused_update_from_tiles(
        labels, labels, deg_t, noise, valid, pen, src_local, dst, w, perm,
        inv_perm, tile_v=128, k_pad=k_pad, k=k, current_bonus=1e-6,
        degree_weighted=weighted, interpret=True)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("k", KS)
def test_fused_propose_ref_matches_pallas(padded, k, weighted):
    g, num_real = padded
    labels, noise, pen = _inputs(g, k, seed=100 + k)
    tiled = build_tiled_csr(g, tile_v=128, tile_e=128)
    valid = np.arange(g.num_vertices) < num_real
    want = _pallas_fused(
        jnp.asarray(labels), jnp.asarray(tiled.deg_t), jnp.asarray(noise),
        jnp.asarray(valid), jnp.asarray(pen), jnp.asarray(tiled.src_local),
        jnp.asarray(tiled.dst), jnp.asarray(tiled.weight),
        jnp.asarray(tiled.perm), jnp.asarray(tiled.inv_perm), k=k,
        k_pad=-(-k // 128) * 128, weighted=weighted)
    csr = graph_from_reference(g).to_device("cpu")
    t = [torch.from_numpy(x) for x in (labels, pen, noise)]
    plain = ref.fused_propose_ref(t[0], csr.src, csr.dst, csr.weight,
                                  csr.deg_w, t[1], t[2], num_real, k, 1e-6,
                                  weighted)
    wrapped = fused_update(t[0], csr.row_ptr, csr.dst, csr.weight, csr.deg_w,
                           t[1], t[2], num_real, k, 1e-6, weighted)
    for got in (plain, wrapped):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


def test_propose_ref_first_match_argmax():
    """Exact ties go to the smallest column, as jnp.argmax does."""
    scores = torch.tensor([[1.0, 1.0, 0.0], [0.0, 2.0, 2.0]])
    labels = torch.tensor([2, 0], dtype=torch.int32)
    best, tb, tc, m = ref.propose_ref(
        scores, labels, torch.tensor([1.0, 2.0]), torch.zeros(3),
        torch.zeros(2, 3), torch.tensor([True, True]), 3, 0.0, True)
    assert best.tolist() == [0, 1]
    assert tb.tolist() == [1.0, 1.0] and tc.tolist() == [0.0, 0.0]
    assert m.tolist() == [1.0, 2.0, 0.0]


def test_wrappers_validate_inputs(padded):
    g, num_real = padded
    csr = graph_from_reference(g).to_device("cpu")
    labels = torch.zeros(g.num_vertices, dtype=torch.int32)
    with pytest.raises(TypeError):
        spinner_scores(labels.long(), csr.row_ptr, csr.dst, csr.weight, 4)
    with pytest.raises(ValueError):
        spinner_scores(labels[:-1], csr.row_ptr, csr.dst, csr.weight, 4)
    with pytest.raises(ValueError):
        spinner_scores(labels, csr.row_ptr, csr.dst, csr.weight[:-1], 4)
    noise = torch.zeros(g.num_vertices, 4)
    with pytest.raises(ValueError):
        fused_update(labels, csr.row_ptr, csr.dst, csr.weight, csr.deg_w,
                     torch.zeros(4), noise.t(), num_real, 4, 1e-6, True)
    with pytest.raises(ValueError):
        fused_update(labels, csr.row_ptr, csr.dst, csr.weight, csr.deg_w,
                     torch.zeros(4), noise, g.num_vertices + 1, 4, 1e-6,
                     True)


def test_cpu_tensors_never_launch(padded):
    g, num_real = padded
    csr = graph_from_reference(g).to_device("cpu")
    labels = torch.zeros(g.num_vertices, dtype=torch.int32)
    before = (spinner_scores.launches, fused_update.launches)
    spinner_scores(labels, csr.row_ptr, csr.dst, csr.weight, 4)
    fused_update(labels, csr.row_ptr, csr.dst, csr.weight, csr.deg_w,
                 torch.zeros(4), torch.zeros(g.num_vertices, 4), num_real, 4,
                 1e-6, True)
    assert (spinner_scores.launches, fused_update.launches) == before


def test_wrappers_have_no_fallback():
    """A CUDA tensor launches the kernel or raises: no ``try`` anywhere in
    the wrappers or the build that could fall back to the plain version."""
    for module in (wrappers, wrappers._build):
        tree = ast.parse(inspect.getsource(module))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], \
            module.__name__
    assert Path(wrappers.__file__).with_name("csrc").joinpath(
        "spinner_scores.cu").exists()


@pytest.mark.parametrize("seeded", [False, True])
def test_fused_layout_fits_shared_memory(seeded):
    """Every k the K1 wrappers took before the row-group design (up to
    6144, the old one-row-a-warp limit) still has a layout: at least one
    warp, 1 to 32 rows a group, 32 at the main path's k = 32 unseeded,
    and a block's shared memory within 227 KB."""
    for k in range(1, 6145):
        warps, rows, smem = wrappers.fused_layout(k, seeded)
        assert 1 <= warps <= 8 and 1 <= rows <= 32
        assert smem <= wrappers.MAX_SMEM_BYTES == 227 * 1024
    assert wrappers.fused_layout(32, False)[:2] == (8, 32)
    with pytest.raises(ValueError):
        wrappers.fused_layout(0, seeded)


def test_scores_layout_fits_shared_memory():
    """Every k the K2 wrapper took before the row-group design (up to
    12,288, the old static shared-memory limit) still has a layout: 1 to 8
    warps, 1 to 32 rows a group (32 at the main path's k = 32, fewer as k
    grows), a block's shared memory within 227 KB; the new limit is
    k = 58,043, one row of one warp."""
    last_rows = 32
    for k in range(1, 12289):
        warps, rows, smem = wrappers.scores_layout(k)
        assert 1 <= warps <= 8 and 1 <= rows <= last_rows
        assert smem <= wrappers.MAX_SMEM_BYTES
        last_rows = rows
    assert wrappers.scores_layout(32) == (8, 32, 8 * (272 + 32 * 33 * 4))
    assert wrappers.scores_layout(58043) == (1, 1, wrappers.MAX_SMEM_BYTES)
    for k in (0, 58044):
        with pytest.raises(ValueError):
            wrappers.scores_layout(k)
