"""Label-driven vertex placement for the application engine (one device).

Spinner's output is a label per vertex; a Pregel runtime consumes it by
PLACING each partition's vertices on one worker so most edges become
worker-local.  This module turns any label vector (a Spinner assignment,
or the hash baseline) into the engine's layout:

  1. sort vertices by label (stable) and chop the order into ``ndev``
     equal ranges -- device p owns new ids ``[p*v_per_dev + i)``
     (``placement_from_labels``, the same chop as the JAX package's, so
     both placements are vertex-balanced and the hash-vs-spinner
     comparison isolates communication, not load);
  2. permute the graph through that placement, pad it to the shared
     vertex bucket (``shape_bucket``; pads are tail vertices with no
     edges) and sort it into a CSR by (new src, new dst) -- on the run's
     device, with one ``torch.sort`` of the packed int64 key;
  3. split the edges into ``[interior | frontier]``: at one device every
     edge is interior and the frontier CSR is empty, so the frontier
     kernel's fold is seeded by the interior partial and adds nothing.
     The multi-device engine fills the frontier in.

The CSR carries NO pad slots: pad vertices are rows with no edges.  The
JAX package's tiled layout needs a weight mask only to disable its pad
slots, so the port's kernels read no mask.

The layout is cached on the graph per (device, labels digest), so the
runs of several workloads on one placement share one relayout.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..core.engine import V_FLOOR
from ..core.graph import Graph, shape_bucket


def placement_from_labels(labels: np.ndarray, ndev: int,
                          v_per_dev: int) -> tuple:
    """(perm, counts): new vertex ids under label-sorted equal chop.

    ``perm[v]`` is vertex v's new id; device p owns new ids
    ``[p * v_per_dev, p * v_per_dev + counts[p])`` with ``counts`` the
    near-equal real-vertex split (pads fill the tail of each device's
    range).
    """
    n = len(labels)
    counts = np.full(ndev, n // ndev, np.int64)
    counts[: n % ndev] += 1
    if counts.max() > v_per_dev:
        raise ValueError(f"{n} vertices do not fit {ndev} x {v_per_dev}")
    order = np.argsort(labels, kind="stable")
    perm = np.empty(n, np.int64)
    start = 0
    for p in range(ndev):
        sel = order[start:start + counts[p]]
        perm[sel] = p * v_per_dev + np.arange(counts[p])
        start += counts[p]
    return perm.astype(np.int32), counts.astype(np.int32)


class AppLayout:
    """A placed, padded view of one (graph, labels) on one device.

    Fields:
      perm: (V,) int32 numpy, old -> new vertex ids.
      counts: (1,) int32 numpy, real vertices on the device.
      v_pad: padded vertex count (``shape_bucket(V, V_FLOOR)``).
      row_ptr, dst: the permuted CSR on ``device`` -- int64 (v_pad + 1,)
        and int32 (E,), entries in (src, dst) order, the arrays of the
        JAX package's ``_finish(perm[src], perm[dst], w, v_pad)``.
      frontier_row_ptr, frontier_dst: the frontier CSR (empty here).
      deg_cnt: (v_pad,) float32 UNWEIGHTED out-degree (directed CSR
        entries per source) -- PageRank's share divisor, matching
        ``core.pregel``'s oracle, which ignores Eq. 3 weights.
      valid: (v_pad,) bool, the real vertices (new ids below V).
      edge_counts: (1,) int64 numpy, real directed edges on the device.
    """

    def __init__(self, graph: Graph, labels: np.ndarray, device):
        labels = np.asarray(labels)
        v = graph.num_vertices
        if len(labels) != v:
            raise ValueError(f"labels cover {len(labels)} vertices, graph "
                             f"has {v}")
        if graph.weight.size and not (graph.weight > 0).all():
            raise ValueError("graph carries weight-0 entries (a padded "
                             "view?): pass the graph itself")
        dev = torch.device(device)
        self.device = dev
        self.v_pad = v_pad = shape_bucket(v, floor=V_FLOOR)
        self.num_real = v
        self.perm, self.counts = placement_from_labels(labels, 1, v_pad)
        perm = torch.from_numpy(self.perm).to(dev)
        src = torch.index_select(perm, 0, torch.from_numpy(
            np.ascontiguousarray(graph.src, np.int32)).to(dev))
        dst = torch.index_select(perm, 0, torch.from_numpy(
            np.ascontiguousarray(graph.dst, np.int32)).to(dev))
        counts = torch.bincount(src, minlength=v_pad)
        key = src.long() * v_pad + dst
        del src, dst
        key = torch.sort(key, stable=True).values
        self.dst = (key % v_pad).to(torch.int32)
        del key
        self.row_ptr = torch.zeros(v_pad + 1, dtype=torch.int64, device=dev)
        torch.cumsum(counts, 0, out=self.row_ptr[1:])
        self.deg_cnt = counts.to(torch.float32)
        self.frontier_row_ptr = torch.zeros_like(self.row_ptr)
        self.frontier_dst = self.dst.new_empty(0)
        self.valid = torch.arange(v_pad, device=dev) < v
        self.edge_counts = np.array([graph.num_directed_entries], np.int64)

    def unpermute(self, values_pad: np.ndarray) -> np.ndarray:
        """Map a (v_pad,) result back to original vertex order, (V,)."""
        return np.asarray(values_pad).reshape(-1)[self.perm]


def _digest(labels: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(labels, np.int64).tobytes(),
                           digest_size=8).hexdigest()


def build_app_layout(graph: Graph, labels: np.ndarray, device) -> AppLayout:
    """The cached relayout (one per graph x device x labels digest)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = ("app-layout", str(dev), _digest(np.asarray(labels)))
    layout = graph._cache.get(key)
    if layout is None:
        layout = graph._cache[key] = AppLayout(graph, labels, dev)
    return layout
