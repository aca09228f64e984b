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
from repro_torch.apps import build_app_layout, run_app
from repro_torch.core import (EngineOptions, SpinnerConfig, engine,
                              generators, partition)
from repro_torch.kernels import ref
from repro_torch.kernels.pregel_combine import pregel_combine, pregel_reduce
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


# (combine, update, bias) of the Pregel workloads
PREGEL = [("sum", "pagerank", 0), ("min", "min", 0), ("min", "min", 1)]


@pytest.mark.parametrize("combine,update,bias", PREGEL)
def test_pregel_kernels_match_plain(cuda, combine, update, bias):
    """Both combine kernels, with and without a seed, over the full CSR
    and the empty frontier: min bitwise, sum within float32 tolerance and
    bitwise equal to itself across launches."""
    g = generators.powerlaw_ba(3000, 5, seed=4)        # hub rows > 32 edges
    labels = np.random.default_rng(1).integers(0, 8, g.num_vertices)
    lay = build_app_layout(g, labels, cuda)
    gen = np.random.default_rng(9 + bias)
    v = lay.v_pad
    if combine == "sum":
        arrays = [gen.uniform(0, 1e-3, v).astype(np.float32)
                  for _ in range(3)]
    else:
        arrays = [gen.integers(0, g.num_vertices, v).astype(np.int32)
                  for _ in range(3)]
        for a in arrays:
            a[gen.random(v) < 0.3] = ref.INF_I32
    send, values, init = (torch.from_numpy(a).to(cuda) for a in arrays)
    base = float(np.float32(0.15 / g.num_vertices))

    def same(a, b):
        if combine == "min" or a.dtype == torch.bool:
            return torch.equal(a, b)
        return torch.allclose(a, b, rtol=1e-5, atol=1e-9)

    csrs = ((lay.row_ptr, lay.dst), (lay.frontier_row_ptr, lay.frontier_dst))
    for (rp, dst), seed in ((c, s) for c in csrs for s in (None, init)):
        n = pregel_reduce.launches
        got = pregel_reduce(send, rp, dst, combine=combine, bias=bias,
                            acc_init=seed)
        again = pregel_reduce(send, rp, dst, combine=combine, bias=bias,
                              acc_init=seed)
        assert pregel_reduce.launches == n + 2
        assert _bits_equal(got, again)
        assert same(got, ref.pregel_reduce_ref(send, rp, dst,
                                               combine=combine, bias=bias,
                                               acc_init=seed))
        kw = dict(combine=combine, update=update, damping=0.85, bias=bias,
                  acc_init=seed)
        n = pregel_combine.launches
        got = pregel_combine(send, rp, dst, values, lay.valid, base, **kw)
        again = pregel_combine(send, rp, dst, values, lay.valid, base, **kw)
        assert pregel_combine.launches == n + 2
        assert all(_bits_equal(a, b) for a, b in zip(got, again))
        want = ref.pregel_combine_ref(send, rp, dst, values, lay.valid,
                                      base, **kw)
        assert all(same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("workload", ["pagerank", "wcc", "bfs", "sssp"])
def test_run_app_on_card_matches_cpu(cuda, workload):
    """The card's run walks the CPU run (which the CPU tests hold to the
    reference); each kernel launches once per superstep."""
    g = generators.watts_strogatz(3000, 10, 0.25, seed=7)
    labels = (np.arange(g.num_vertices) * 2654435761 % 8).astype(np.int32)
    want = run_app(g, labels, workload, device="cpu")
    pregel_reduce.launches = pregel_combine.launches = 0
    got = run_app(g, labels, workload, device=cuda)
    assert pregel_reduce.launches == pregel_combine.launches \
        == got.supersteps == want.supersteps
    assert got.converged == want.converged
    if workload == "pagerank":
        np.testing.assert_allclose(got.values, want.values, rtol=1e-4,
                                   atol=1e-9)
    else:
        np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.device_messages, want.device_messages)
    torch_run = run_app(g, labels, workload, combine="torch", device=cuda)
    assert torch_run.supersteps == got.supersteps
