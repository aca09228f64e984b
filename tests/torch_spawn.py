"""Run a multi-rank case of the port beside the reference's, on the CPU.

The port runs SPMD: one process per rank, spawned with
``torch.multiprocessing`` into a gloo group on a ``FileStore`` under the
test's temporary directory (no TCP port, so parallel test workers cannot
collide).  The reference runs the same cases over ``world`` forced host
devices in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count``).  Both start
together; each writes its results under the temporary directory.
"""
import os
import subprocess
import sys
from pathlib import Path

import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parents[1]


def run_world(tmp: Path, world: int, worker, reference: str, ref_args,
              timeout: float) -> tuple:
    """Run ``reference`` (a script, argv ``world out *ref_args``) and
    ``worker(rank, world, store, out_pattern)`` on every rank; returns the
    reference's output path and the ranks' (``% rank``) pattern.  Fails
    the test if any process fails or outlives ``timeout``."""
    data = str(tmp / "reference.npz")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={world}")
    ref = subprocess.Popen(
        [sys.executable, "-c", reference, str(world), data, *ref_args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    out = {}
    try:
        port = run_ranks(tmp, world, worker, timeout, wait=lambda: out.update(
            err=ref.communicate(timeout=timeout)[1]))
    finally:
        ref.kill()
    assert ref.returncode == 0, out["err"][-3000:]
    return data, port


def run_ranks(tmp: Path, world: int, worker, timeout: float,
              wait=None) -> str:
    """Run ``worker(rank, world, store, out_pattern)`` on every rank (the
    port's side alone); ``wait()``, if given, runs while the ranks do.
    Returns the ranks' (``% rank``) output pattern; fails the test if a
    rank fails or outlives ``timeout``."""
    port = str(tmp / "port-%d.npz")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker,
                         args=(r, world, str(tmp / "store"), port))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        if wait is not None:
            wait()
    finally:
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return port
