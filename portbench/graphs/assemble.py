"""Eq. 3 on the device: a directed edge list to the weighted symmetric CSR.

The same arrays as the repository's host build (``from_edges`` with
``directed=True``): self-loops and repeated directed edges dropped, one
weight per unordered pair -- 1 if one direction is present, 2 if both --
both directions stored, sorted by (src, dst), with the CSR row pointer
and the weighted degrees.  Sorting and merging run as ``torch.unique`` /
``torch.sort`` on the edge list's device.
"""
from __future__ import annotations

import torch


def assemble(src: torch.Tensor, dst: torch.Tensor, n: int) -> dict:
    """``src``, ``dst`` (int32), ``weight`` (float32), ``row_ptr``
    (int64, n + 1) and ``deg_w`` (float32, n) on the input's device."""
    src, dst = src.long(), dst.long()
    keep = src != dst
    directed = torch.unique(src[keep] * n + dst[keep])
    del keep
    s, d = directed // n, directed % n
    del directed
    pairs, count = torch.unique(torch.minimum(s, d) * n + torch.maximum(s, d),
                                return_counts=True)
    del s, d
    lo, hi = pairs // n, pairs % n
    del pairs
    w = count.to(torch.float32)
    sym_src = torch.cat([lo, hi])
    sym_dst = torch.cat([hi, lo])
    del lo, hi
    order = torch.argsort(sym_src * n + sym_dst)
    sym_src, sym_dst = sym_src[order], sym_dst[order]
    weight = torch.cat([w, w])[order]
    del order
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(torch.bincount(sym_src, minlength=n), 0, out=row_ptr[1:])
    deg_w = torch.zeros(n, dtype=torch.float32,
                        device=src.device).index_add_(0, sym_src, weight)
    return {"src": sym_src.to(torch.int32), "dst": sym_dst.to(torch.int32),
            "weight": weight, "row_ptr": row_ptr, "deg_w": deg_w}
