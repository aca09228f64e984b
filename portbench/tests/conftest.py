"""Shared pieces of the benchmark's CPU tests: tiny copies of the cells'
configurations and mixes, so a whole run fits a test."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench.harness import spec  # noqa: E402

TINY_GRAPH = {"watts_strogatz": {"n": 1500, "k_nbrs": 6},
              "chung_lu": {"n": 2000, "pairs": 9000}}
BIG_SEED = 2 ** 31 + 11


def tiny(cell: str) -> tuple:
    """(config, mix) of ``cell`` cut to a CPU test's size."""
    bench = spec.bench()
    w = spec.workload(bench, cell)
    config = copy.deepcopy(spec.config(w["config"]))
    config["graph"].update(TINY_GRAPH[config["graph"]["generator"]])
    mix = copy.deepcopy(spec.traffic(w["traffic"]))
    if mix["kind"] == "adapt":
        mix.update(pairs_per_batch=12, max_batches=12)
    return config, mix


@pytest.fixture
def run_tiny():
    """``run_tiny(cell, **kw) -> (result, checks)``, on the CPU unless
    ``device=`` says otherwise."""
    import time

    from portbench.harness import cell as cell_mod

    def go(name, seed=BIG_SEED, seconds=0.5, device="cpu", **kw):
        config, mix = tiny(name)
        return cell_mod.run_cell(name, seed, seconds, False, device,
                                 time.perf_counter(), config=config, mix=mix,
                                 log=lambda msg: None, **kw)
    return go
