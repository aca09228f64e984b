"""Watts-Strogatz small worlds (the paper's Section 5.2 scalability graph).

A directed ring lattice, each vertex linked to its ``k_nbrs`` successors,
with a fraction ``beta`` of edge targets rewired uniformly at random; a
rewired edge that lands on its source moves to the next vertex.  The
repository's ``watts_strogatz`` in torch, drawn on the device.
"""
from __future__ import annotations

import torch

from . import seeded


def edges(spec: dict, seed: int, device):
    n, k, beta = int(spec["n"]), int(spec["k_nbrs"]), float(spec["beta"])
    if not 0 < k < n:
        raise ValueError(f"k_nbrs {k} must lie in (0, {n})")
    g = seeded(seed, device)
    src = torch.arange(n, dtype=torch.int64,
                       device=device).repeat_interleave(k)
    dst = (src + torch.arange(1, k + 1, dtype=torch.int64,
                              device=device).repeat(n)) % n
    rewire = torch.rand(src.numel(), generator=g, device=device) < beta
    dst[rewire] = torch.randint(0, n, (int(rewire.sum()),), generator=g,
                                device=device)
    loop = dst == src
    dst[loop] = (dst[loop] + 1) % n
    return src, dst, n
