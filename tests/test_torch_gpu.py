"""The CUDA kernels and the port's main path on a card.

Every test here needs a CUDA card and skips without one; they import
neither JAX nor the reference package, so they run where only PyTorch
is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CPU tests hold the port's plain versions and CPU runs to the
reference bit for bit; these hold the kernels and the card's runs to the
plain versions and CPU runs, bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.core import (EngineOptions, SpinnerConfig, engine,
                              generators, partition)
from repro_torch.kernels import ref
from repro_torch.kernels.spinner_scores import fused_update, spinner_scores

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
