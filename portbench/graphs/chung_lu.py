"""Chung-Lu graphs with Zipf expected degrees (a social graph's tail).

``pairs`` directed edges, each endpoint drawn with probability
proportional to the expected degree ``i ** (-1 / (exponent - 1))`` of a
rank ``i``, the degrees shuffled over the vertex ids; self-pairs are
dropped, parallel pairs merge in the Eq. 3 build.  The repository's
``chung_lu_zipf`` in torch, drawn on the device.
"""
from __future__ import annotations

import torch

from . import seeded


def edges(spec: dict, seed: int, device):
    n, m = int(spec["n"]), int(spec["pairs"])
    exponent = float(spec["exponent"])
    g = seeded(seed, device)
    rank = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    weight = rank ** (-1.0 / (exponent - 1.0))
    cdf = torch.cumsum(weight[torch.randperm(n, generator=g, device=device)],
                       0)
    cdf /= cdf[-1].clone()
    draws = torch.rand(2, m, generator=g, device=device, dtype=torch.float64)
    ends = torch.searchsorted(cdf, draws, right=True).clamp_(max=n - 1)
    keep = ends[0] != ends[1]
    return ends[0][keep], ends[1][keep], n
