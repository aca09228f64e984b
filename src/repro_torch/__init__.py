"""repro_torch: Spinner graph partitioning in PyTorch, with CUDA kernels
written by hand for Hopper (sm_90a).

The port of the JAX package ``repro`` (which stays beside it as the
reference).  It imports neither JAX nor ``repro``.  Its entry points run
on the CUDA card unless the caller asks for the CPU::

    from repro_torch.core import SpinnerConfig, generators, partition

    g = generators.watts_strogatz(100_000, 16, 0.3, seed=1)
    res = partition(g, SpinnerConfig(k=32), record_history=False)
    # or, without a card: partition(..., device="cpu")

Ported so far: single-device ``partition`` (fused, chunked and host
runners), the threefry generator that matches ``jax.random`` bit for
bit (``rng``), the CSR score and Pregel combine kernels (``kernels``),
and the single-device Pregel applications (``apps``)::

    from repro_torch.apps import run_app
    run_app(g, res.labels, "pagerank")
"""
__version__ = "0.1.0"
