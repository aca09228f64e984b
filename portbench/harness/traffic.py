"""The one traffic generator: reads a mix's parameters and draws its inputs.

A mix (``portbench/traffic/<name>.json``) is data: the ``kind`` of call it
sends, found by name as ``portbench/kinds/<kind>.py``, and the sizes of
what it sends.  Every input is drawn here, from the call's index and the
run's seed (or the pool's), so the same seed gives the same inputs and a
call's inputs can be drawn again after the window for the reference.

Parameters (each optional unless its kind reads it):

* ``problems``, ``pool_seed``: the calls cycle through a pool of
  ``problems`` inputs drawn from ``pool_seed``, and the run's seed only
  sets the order.  Every run so does the same work in another order;
* ``pairs_per_batch``: directed pairs in one batch of new edges;
* ``endpoints``: how a batch's endpoints are drawn: ``"uniform"`` over
  the vertices (the default) or ``"degree"``, each endpoint the source of
  a uniformly drawn directed entry of the configuration's graph, so in
  proportion to its degree;
* ``max_batches``, ``traced_calls``, ``check_sample``: read by the
  harness (``harness/cell.py``) and the kinds.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graphs import seeded

ENDPOINTS = ("uniform", "degree")


class Traffic:
    def __init__(self, mix: dict, graph: dict, k: int, seed: int, device):
        self.mix, self.k, self.seed, self.device = mix, int(k), seed, device
        self.n = int(graph["num_vertices"])
        self.endpoints = mix.get("endpoints", "uniform")
        if self.endpoints not in ENDPOINTS:
            raise ValueError(f"unknown endpoints {self.endpoints!r}; "
                             f"available: {', '.join(ENDPOINTS)}")
        self._entries = (torch.from_numpy(graph["src"]).to(device)
                         if self.endpoints == "degree" else None)
        self.pool = int(mix.get("problems", 0))
        if self.pool:
            self.order = np.random.default_rng(
                np.random.SeedSequence(seed)).permutation(self.pool)
            self.source = int(mix["pool_seed"])
        else:
            self.source = seed

    @property
    def kind(self) -> str:
        return self.mix["kind"]

    def problem(self, j: int) -> int:
        """The pool entry call ``j`` sends (``j`` itself without a pool)."""
        return int(self.order[j % self.pool]) if self.pool else j

    def _gen(self, stream: int, j: int) -> torch.Generator:
        return seeded(self.source * 1_000_003 + stream * 7_919
                      + self.problem(j), self.device)

    def init_labels(self, j: int) -> np.ndarray:
        """Call ``j``'s initial labels, uniform over the k parts."""
        g = self._gen(1, j)
        return torch.randint(0, self.k, (self.n,), generator=g,
                             device=self.device,
                             dtype=torch.int32).cpu().numpy()

    def spinner_seed(self, j: int) -> int:
        """Call ``j``'s seed of Spinner's random streams (a 32-bit word)."""
        return int(np.random.SeedSequence([self.source, 3, self.problem(j)])
                   .generate_state(1, np.uint32)[0])

    def batch(self, j: int) -> tuple:
        """Batch ``j``'s directed pairs as int32 host arrays."""
        g = self._gen(2, j)
        m = int(self.mix["pairs_per_batch"])
        if self._entries is None:
            ends = torch.randint(0, self.n, (2, m), generator=g,
                                 device=self.device, dtype=torch.int32)
        else:
            pick = torch.randint(0, self._entries.numel(), (2, m),
                                 generator=g, device=self.device)
            ends = self._entries[pick].to(torch.int32)
        ends = ends.cpu().numpy()
        return ends[0], ends[1]
