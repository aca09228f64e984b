"""Label-driven vertex placement for the application engine.

Spinner's output is a label per vertex; a Pregel runtime consumes it by
PLACING each partition's vertices on one worker so most edges become
worker-local.  This module turns any label vector (a Spinner assignment,
or the hash baseline) into the engine's layout over ``ndev`` devices:

  1. sort vertices by label (stable) and chop the order into ``ndev``
     equal ranges -- device p owns new ids ``[p*v_per_dev + i)``
     (``placement_from_labels``, the same chop as the JAX package's, so
     both placements are vertex-balanced and the hash-vs-spinner
     comparison isolates communication, not load);
  2. permute the graph through that placement, pad it to the shared
     vertex bucket (``shape_bucket``; pads are tail vertices of each
     device's range, with no edges) and sort it into a CSR by (new src,
     new dst) -- on the run's device, with one ``torch.sort`` of the
     packed int64 key;
  3. give each rank its two CSRs over its ``v_per_dev`` rows
     (``AppLayout.shard``): the INTERIOR edges (dst owned by the rank, as
     local ids into its slice of the send vector) and the FRONTIER edges
     (dst owned elsewhere, as the exchange plan's index: global ids for
     the allgather and delta plans, the halo plans' ``[local | halo]``
     slots).  Each keeps the CSR order, so a rank's segments hold the
     entries of its row of the JAX package's ``shard_graph``, in order.
     At one device every edge is interior and the frontier CSR is empty.

The CSR carries NO pad slots: pad vertices are rows with no edges.  The
JAX package's tiled layout needs a weight mask only to disable its pad
slots, so the port's kernels read no mask.  The numpy ``ShardedGraph`` of
the placed graph is built only when a halo plan asks for it; the
allgather and delta plans read the layout's sizes alone.

The layout is cached on the graph per (ndev, device, labels digest), and
each rank's segments on the layout per (rank, plan layout), so the runs
of several workloads and plans on one placement share one relayout.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import comm
from ..core.distributed import ShardGeometry, shard_graph
from ..core.engine import V_FLOOR
from ..core.graph import Graph, _finish, shape_bucket


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


class AppShard(NamedTuple):
    """One rank's part of a placed layout, on the layout's device: CSRs
    ``(row_ptr int64 (v_local + 1,), dst int32)`` over its rows."""

    rank: int
    v_local: int
    offset: int                # placed id of local row 0
    interior: tuple            # dst as local ids into the rank's send slice
    frontier: tuple            # dst in the exchange plan's lookup index
    deg_cnt: torch.Tensor      # (v_local,) f32 unweighted out-degree
    valid: torch.Tensor        # (v_local,) bool: local row < counts[rank]


class AppLayout:
    """A placed, padded view of one (graph, labels) over ``ndev`` devices.

    Fields:
      perm: (V,) int32 numpy, old -> new vertex ids.
      counts: (ndev,) int32 numpy, real vertices per device.
      v_pad: padded vertex count (``shape_bucket(V, max(V_FLOOR, ndev))``),
        ``ndev * v_per_dev``.
      row_ptr, dst: the whole permuted CSR on ``device`` -- int64
        (v_pad + 1,) and int32 (E,), entries in (src, dst) order, the
        arrays of the JAX package's ``_finish(perm[src], perm[dst], w,
        v_pad)``.
      deg_cnt: (v_pad,) float32 UNWEIGHTED out-degree (directed CSR
        entries per source; ``view(ndev, v_per_dev)`` is the JAX
        package's shape) -- PageRank's share divisor, matching
        ``core.pregel``'s oracle, which ignores Eq. 3 weights.
      valid: (v_pad,) bool, the real vertices (local id below the owner's
        ``counts``).
      edge_counts: (ndev,) int64 numpy, real directed edges per device.
      frontier_row_ptr, frontier_dst: at one device, the (empty) frontier
        CSR of ``shard(0)``.
    """

    def __init__(self, graph: Graph, labels: np.ndarray, device,
                 ndev: int = 1):
        labels = np.asarray(labels)
        v = graph.num_vertices
        if len(labels) != v:
            raise ValueError(f"labels cover {len(labels)} vertices, graph "
                             f"has {v}")
        if graph.weight.size and not (graph.weight > 0).all():
            raise ValueError("graph carries weight-0 entries (a padded "
                             "view?): pass the graph itself")
        if ndev < 1:
            raise ValueError(f"ndev must be >= 1, got {ndev}")
        v_pad = shape_bucket(v, floor=max(V_FLOOR, ndev))
        if v_pad % ndev:
            raise ValueError(f"the vertex bucket {v_pad} of {v} vertices "
                             f"does not split into {ndev} equal ranges")
        dev = torch.device(device)
        self.device = dev
        self.ndev = ndev
        self.v_pad = v_pad
        self.v_per_dev = vl = v_pad // ndev
        self.num_real = v
        self.perm, self.counts = placement_from_labels(labels, ndev, vl)
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
        owned = torch.from_numpy(self.counts.astype(np.int64)).to(dev)
        local = torch.arange(vl, device=dev)
        self.valid = (local[None, :] < owned[:, None]).reshape(-1)
        self.edge_counts = torch.diff(self.row_ptr[::vl]).cpu().numpy()
        self._shards: dict = {}
        self._plan_layouts: dict = {}

    def unpermute(self, values_pad: np.ndarray) -> np.ndarray:
        """Map a (v_pad,) result back to original vertex order, (V,)."""
        return np.asarray(values_pad).reshape(-1)[self.perm]

    @property
    def frontier_row_ptr(self) -> torch.Tensor:
        return self._one_device().frontier[0]

    @property
    def frontier_dst(self) -> torch.Tensor:
        return self._one_device().frontier[1]

    def _one_device(self) -> AppShard:
        if self.ndev != 1:
            raise ValueError(f"a {self.ndev}-device layout has one frontier "
                             "per rank: use shard(rank)")
        return self.shard(0)

    def exchange_plan(self, graph: Graph, name: str,
                      delta_cap: Optional[int] = None) -> comm.ExchangePlan:
        """The named exchange plan over this layout (``graph`` is the one
        the layout placed).  The halo plans read the numpy
        ``shard_graph(pad=True)`` of the placed graph, built here once;
        allgather and delta read the layout's sizes."""
        if name not in comm.EXCHANGE_PLANS:
            raise ValueError(f"unknown exchange plan {name!r}; available: "
                             f"{', '.join(sorted(comm.EXCHANGE_PLANS))}")
        halo = name in ("halo", "halo_delta")
        key = "sharded" if halo else "geometry"
        sg = self._plan_layouts.get(key)
        if sg is None and halo:
            pgraph = _finish(self.perm[graph.src], self.perm[graph.dst],
                             graph.weight, self.v_pad)
            sg = shard_graph(pgraph, self.ndev, pad=True)
        elif sg is None:
            sg = ShardGeometry(num_vertices=self.v_pad,
                               num_real_vertices=self.v_pad, ndev=self.ndev,
                               v_per_dev=self.v_per_dev)
        self._plan_layouts[key] = sg
        return comm.make_exchange_plan(name, sg, delta_cap=delta_cap,
                                       pad=True)

    def shard(self, rank: int,
              plan: Optional[comm.ExchangePlan] = None) -> AppShard:
        """Rank ``rank``'s segments, with the frontier dst in ``plan``'s
        lookup index (global ids without a plan), cached per (rank, plan
        layout)."""
        if not 0 <= rank < self.ndev:
            raise ValueError(f"rank {rank} outside [0, {self.ndev})")
        halo = self.ndev > 1 and getattr(plan, "name", None) in (
            "halo", "halo_delta")
        key = (rank, ("halo", plan.halo_size) if halo else ("global",))
        shard = self._shards.get(key)
        if shard is None:
            shard = self._shards[key] = self._build_shard(
                rank, plan.frontier_dst[rank] if halo else None)
        return shard

    def _build_shard(self, rank: int,
                     frontier_dst: Optional[np.ndarray]) -> AppShard:
        vl, dev = self.v_per_dev, self.device
        lo, hi = rank * vl, (rank + 1) * vl
        rows = slice(lo, hi)
        if self.ndev == 1:
            empty = (torch.zeros_like(self.row_ptr), self.dst.new_empty(0))
            return AppShard(rank=0, v_local=vl, offset=0,
                            interior=(self.row_ptr, self.dst),
                            frontier=empty, deg_cnt=self.deg_cnt,
                            valid=self.valid)
        e0, e1 = self.row_ptr[[lo, hi]].tolist()
        dst = self.dst[e0:e1]
        src = torch.repeat_interleave(torch.arange(vl, device=dev),
                                      torch.diff(self.row_ptr[lo:hi + 1]))
        inner = torch.div(dst, vl, rounding_mode="floor") == rank
        if frontier_dst is None:
            d_fro = dst[~inner]
        else:
            d_fro = torch.from_numpy(
                np.ascontiguousarray(frontier_dst, np.int32)).to(dev)
            if d_fro.numel() != int((~inner).sum()):
                raise ValueError("the plan's frontier index does not match "
                                 f"rank {rank}'s frontier edges")
        return AppShard(
            rank=rank, v_local=vl, offset=lo,
            interior=(_row_ptr(src[inner], vl), dst[inner] - lo),
            frontier=(_row_ptr(src[~inner], vl), d_fro),
            deg_cnt=self.deg_cnt[rows], valid=self.valid[rows])

    def halo_count(self) -> int:
        """The distinct (owner, remote vertex) pairs of the frontier
        entries, counted on the layout's device: the values a halo
        exchange moves each superstep (``HaloPlan.true_halo``)."""
        return sum(int(torch.unique(self.shard(r).frontier[1]).numel())
                   for r in range(self.ndev))


def _row_ptr(src: torch.Tensor, rows: int) -> torch.Tensor:
    """The (rows + 1,) int64 row pointer of entries sorted by ``src``."""
    row_ptr = torch.zeros(rows + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(torch.bincount(src, minlength=rows), 0, out=row_ptr[1:])
    return row_ptr


def _digest(labels: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(labels, np.int64).tobytes(),
                           digest_size=8).hexdigest()


def build_app_layout(graph: Graph, labels: np.ndarray, device,
                     ndev: int = 1) -> AppLayout:
    """The cached relayout (one per graph x ndev x device x labels
    digest)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = ("app-layout", ndev, str(dev), _digest(np.asarray(labels)))
    layout = graph._cache.get(key)
    if layout is None:
        layout = graph._cache[key] = AppLayout(graph, labels, dev, ndev)
    return layout
