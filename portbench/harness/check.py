"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``portbench/reference``) recomputes a sample of the window's
answers, drawn from the run's seed, from the same inputs, and each
answer is held to it by three numbers, each the worst over the sample:

* ``label_mismatch``: vertices whose label differs;
* ``loads_gap``: the largest |difference| of a part's load B(l), which
  also holds an ``adapt`` to the merged graph's degrees;
* ``iter_gap``: the largest |difference| of the iteration count, which
  holds the run to the reference's halt.

Every score sum is an exact integer in float32 and the reference keeps
the program's op order, so every limit is 0: the comparison is exact.  A
run is correct only if it checked at least one answer and no call
failed (raised, or left the delta fast path).  Which answers are held to
what is the kind's (``kinds/<kind>.py``, ``check``); this module holds
the reference run, the numbers and their limits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference import spinner as ref

LIMITS = {"label_mismatch": 0, "loads_gap": 0.0, "iter_gap": 0}


def compare(got: ref.Answer, want: ref.Answer) -> dict:
    return {"label_mismatch": int(np.count_nonzero(got.labels != want.labels)),
            "loads_gap": float(np.max(np.abs(got.loads.astype(np.float64)
                                              - want.loads))),
            "iter_gap": abs(got.iterations - want.iterations)}


def worst(readings: list) -> dict:
    return {name: max([r[name] for r in readings], default=zero)
            for name, zero in LIMITS.items()}


def sample(n: int, size: int, seed: int) -> list:
    """``size`` of the window's ``n`` calls, drawn from ``seed``."""
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    return sorted(rng.choice(n, size=min(size, n), replace=False).tolist())


class Judge:
    """Runs the reference on the inputs a kind hands it and keeps the
    numbers of each answer held to it."""

    def __init__(self, graph: dict, params: ref.Params, spinner_seed: int,
                 device):
        self.params, self.seed, self.device = params, spinner_seed, device
        self.edges = ref.host_edges(graph, device)
        n = graph["num_vertices"]
        self.base_total = ref.float32_total(self.edges.deg[:n].cpu().numpy())
        self.readings = []

    def against(self, answer: ref.Answer, edges: ref.Edges, init, total: float,
                seed=None) -> None:
        """Hold ``answer`` to the reference's run on ``edges`` from labels
        ``init`` with capacity from ``total`` (and the run's seed unless
        ``seed`` is given)."""
        want = ref.run(edges, self.params, torch.from_numpy(init),
                       ref.capacity(self.params, total),
                       self.seed if seed is None else seed)
        self.readings.append(compare(answer, want))


def check(run, graph: dict, params: ref.Params, spinner_seed: int,
          device, log, kind) -> dict:
    """The numbers compared for one finished run (``cell.Run``) of the
    traffic kind ``kind``."""
    judge = Judge(graph, params, spinner_seed, device)
    picked = sample(len(run.window), int(run.traffic.mix["check_sample"]),
                    run.sample_seed)
    kind.check(run, judge, picked)
    log(f"checked {len(judge.readings)} answers against the reference")
    out = worst(judge.readings)
    out["checked"] = len(judge.readings)
    return out


def verdict(nums: dict, failed: int) -> bool:
    return nums["checked"] > 0 and failed == 0 and all(
        nums[name] <= limit for name, limit in LIMITS.items())
