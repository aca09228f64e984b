"""Sharded Spinner: the edge-shard layout layer and the host-driven entry
points.

The iteration itself lives in ``repro_torch.core.engine`` (the sharded
runner, SPMD over ``torch.distributed``).  What remains here:

  * ``ShardedGraph`` / ``shard_graph`` -- the reference's layout, in numpy:
    vertices range-partitioned across devices (ceil(V/ndev) contiguous
    ids), edges living on their source's owner, each shard's row
    ``[interior | frontier]`` (dst owned locally vs remotely), CSR order
    kept inside each segment, ``edge_perm`` the original slot of every
    entry.  The layout tests and the halo plans read it.
  * ``ShardGeometry`` -- the layout's sizes alone, which is all the
    allgather and delta plans need.
  * ``RankShard`` / ``rank_shard`` -- one rank's segments on its device, as
    the kernels read them: CSRs over the rank's ``v_per_dev`` rows of the
    interior edges (dst as local ids into the label shard), of the
    frontier edges (dst as the exchange plan's index) and of both (the
    whole shard, for the schedule without overlap).  Only the rank's slice
    of the host CSR is uploaded, and the split is a mask over it, which
    keeps each segment in CSR order: the same entries, in the same order,
    as the rank's row of ``shard_graph``.
  * ``comm_stats`` -- the per-iteration communication volume;
  * ``make_sharded_step`` / ``run_sharded_hostloop`` -- one iteration per
    call, the host syncing on ``halted`` every iteration (the
    dispatch-overhead baseline), same trajectory as ``run_sharded``;
  * ``partition_distributed`` -- ``partition(engine="sharded")`` returning
    (labels, comm stats);
  * ``EdgeShardView`` / ``shard_graph(local_only=, seg_widths=)`` -- the
    multi-host loading path of the cluster bootstrap: one host's row built
    from its edge file alone.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import engine
from .graph import Graph, shape_bucket

@dataclasses.dataclass(frozen=True)
class ShardGeometry:
    """The sizes of a sharded layout: enough for plans that read no edges."""

    num_vertices: int          # padded to an ndev multiple
    num_real_vertices: int
    ndev: int
    v_per_dev: int
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Host-side edge shards, one row per device, interior-first.

    Columns ``[0, e_interior)`` of a device's row are INTERIOR edges (dst
    owned by the same device, readable from the local label shard) and
    columns ``[e_interior, E_shard)`` FRONTIER edges (dst label arrives by
    the exchange plan).  Within each segment the CSR order is kept;
    ``edge_perm`` records each slot's index in the original ``Graph``
    arrays (-1 for padding).
    """

    num_vertices: int          # padded to ndev multiple
    num_real_vertices: int
    ndev: int
    v_per_dev: int
    src_local: np.ndarray      # (ndev, E_shard) int32, src - owner_offset
    dst: np.ndarray            # (ndev, E_shard) int32 global ids
    weight: np.ndarray         # (ndev, E_shard) f32, 0 = padding
    deg_w: np.ndarray          # (ndev, v_per_dev) f32
    e_interior: int = 0        # static split column (padded segment width)
    interior_counts: Optional[np.ndarray] = None  # (ndev,) real interior
    frontier_counts: Optional[np.ndarray] = None  # (ndev,) real frontier
    edge_perm: Optional[np.ndarray] = None  # (ndev, E_shard) orig idx | -1
    local_only: Optional[int] = None
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)


@dataclasses.dataclass(frozen=True)
class EdgeShardView:
    """One host's edge file as ``shard_graph(local_only=...)`` input.

    The cluster bootstrap (``repro_torch.cluster.bootstrap``) splits a
    graph's directed entries by owning host into one file per host; a
    worker loads ONLY its file, so it never holds the full O(E) edge set.
    ``deg_w`` is the full (V,) weighted-degree vector, the O(V) vertex
    state shipped beside the files.
    """

    num_vertices: int
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    deg_w: np.ndarray


def shard_graph(graph, ndev: int, pad: bool = False, *,
                local_only: Optional[int] = None,
                seg_widths: Optional[Tuple[int, int]] = None
                ) -> ShardedGraph:
    """Range-partition vertices and edges into per-device shards.

    Contiguous blocks of ceil(V/ndev) vertex ids per device; every real
    edge (weight > 0) is stored with its source's owner and ordered
    ``[interior | frontier]``, CSR order kept in each segment.  ``pad``
    buckets each segment's width: the interior with ``shape_bucket``, the
    frontier to a power of two (at least 128).  Pad slots carry weight 0
    and point at the device's own vertex 0.  At one device every edge is
    interior.

    ``local_only=p`` is the per-host loading path: ``graph`` holds ONLY
    host ``p``'s edges (a ``Graph`` or an ``EdgeShardView`` of one edge
    file) and the result has a single row, byte for byte row ``p`` of the
    full layout when ``seg_widths`` passes the agreed raw ``(max interior,
    max frontier)`` counts (the shard manifest's; bucketed by ``pad`` as
    above).  Without ``seg_widths`` the widths are the host's own counts.
    """
    v_per_dev = -(-graph.num_vertices // ndev)
    v_pad = v_per_dev * ndev
    real = graph.weight > 0
    owner_all = graph.src // v_per_dev
    frontier_all = (graph.dst // v_per_dev) != owner_all
    oidx_all = np.arange(graph.src.shape[0], dtype=np.int32)
    owner, frontier = owner_all[real], frontier_all[real]
    if local_only is not None:
        if not 0 <= local_only < ndev:
            raise ValueError(f"local_only={local_only} outside [0, {ndev})")
        if owner.size and not (owner == local_only).all():
            raise ValueError(
                f"local_only={local_only}: edge list contains edges owned "
                f"by hosts {sorted(set(np.unique(owner)) - {local_only})}")
    n_int, n_fro = _counts(owner, frontier, ndev)
    if local_only is None:
        raw = (n_int.max(), n_fro.max())
    elif seg_widths is not None:
        raw = seg_widths
    else:
        raw = (n_int[local_only], n_fro[local_only])
    e_int, e_fro = _widths(int(raw[0]), int(raw[1]), pad)
    e_shard = e_int + e_fro
    devs = range(ndev) if local_only is None else (local_only,)
    rows = len(devs)
    src_l = np.zeros((rows, e_shard), np.int32)
    w = np.zeros((rows, e_shard), np.float32)
    perm = np.full((rows, e_shard), -1, np.int32)
    # pad slots read the owner's vertex 0 under every dst layout
    dst = np.tile((np.asarray(devs, np.int32) * v_per_dev)[:, None],
                  (1, e_shard))
    # stable sort by (owner, frontier flag): per device, the interior run
    # comes first, each run in CSR order
    order = np.argsort(owner.astype(np.int64) * 2 + frontier, kind="stable")
    s = graph.src[real][order]
    d = graph.dst[real][order]
    ww = graph.weight[real][order]
    oidx = oidx_all[real][order]
    starts = np.zeros(2 * ndev + 1, np.int64)
    np.cumsum(np.stack([n_int, n_fro], axis=1).reshape(-1), out=starts[1:])
    for row, p in enumerate(devs):
        for lo, hi, col in ((starts[2 * p], starts[2 * p + 1], 0),
                            (starts[2 * p + 1], starts[2 * p + 2], e_int)):
            n = hi - lo
            src_l[row, col: col + n] = s[lo:hi] - p * v_per_dev
            dst[row, col: col + n] = d[lo:hi]
            w[row, col: col + n] = ww[lo:hi]
            perm[row, col: col + n] = oidx[lo:hi]
    if local_only is None:
        deg = np.zeros(v_pad, np.float32)
        deg[: graph.num_vertices] = graph.deg_w
        deg = deg.reshape(ndev, v_per_dev)
    else:
        # deg_w is the full (V,) vector: take this host's range
        p = local_only
        deg = np.zeros((1, v_per_dev), np.float32)
        lo, hi = p * v_per_dev, min((p + 1) * v_per_dev, graph.num_vertices)
        deg[0, : hi - lo] = np.asarray(graph.deg_w)[lo:hi]
        n_int, n_fro = n_int[[p]], n_fro[[p]]
    return ShardedGraph(num_vertices=v_pad,
                        num_real_vertices=graph.num_vertices, ndev=ndev,
                        v_per_dev=v_per_dev, src_local=src_l, dst=dst,
                        weight=w, deg_w=deg, e_interior=e_int,
                        interior_counts=n_int, frontier_counts=n_fro,
                        edge_perm=perm, local_only=local_only)


def _counts(owner: np.ndarray, frontier: np.ndarray, ndev: int) -> tuple:
    """Per-device counts of real interior and frontier entries."""
    return (np.bincount(owner[~frontier], minlength=ndev).astype(np.int64),
            np.bincount(owner[frontier], minlength=ndev).astype(np.int64))


def _widths(e_int: int, e_fro: int, pad: bool) -> tuple:
    """The segment widths of raw widths ``(e_int, e_fro)``, bucketed with
    ``pad`` (the interior by ``shape_bucket``, the frontier to a power of
    two, at least 128)."""
    if e_int + e_fro == 0:
        e_int = 1                       # keep one (zeroed) slot per shard
    if pad:
        e_int = shape_bucket(e_int, floor=128)
        if e_fro:                       # 1-device shards stay frontier-free
            e_fro = max(128, 1 << (e_fro - 1).bit_length())
    return e_int, e_fro


def segment_widths(graph: Graph, ndev: int, pad: bool = False) -> tuple:
    """``shard_graph(graph, ndev, pad)``'s segment sizes without its
    arrays: ``(interior_counts, frontier_counts, e_interior, e_shard)``,
    cached on the graph.  The sharded delta's slot accounting reads them
    (``core.delta.init_sharded_csr``)."""
    key = ("segments", ndev, pad)
    out = graph._cache.get(key)
    if out is None:
        v_per_dev = -(-graph.num_vertices // ndev)
        real = graph.weight > 0
        owner = graph.src[real] // v_per_dev
        n_int, n_fro = _counts(
            owner, (graph.dst[real] // v_per_dev) != owner, ndev)
        e_int, e_fro = _widths(int(n_int.max()), int(n_fro.max()), pad)
        out = graph._cache[key] = (n_int, n_fro, e_int, e_int + e_fro)
    return out


def shard_layout(graph: Graph, ndev: int, pad: bool = False) -> ShardedGraph:
    """The ``ShardedGraph`` of (graph, ndev, pad), cached on the graph."""
    key = ("sharded", ndev, pad)
    sg = graph._cache.get(key)
    if sg is None:
        sg = graph._cache[key] = shard_graph(graph, ndev, pad=pad)
    return sg


def shard_geometry(graph: Graph, ndev: int) -> ShardGeometry:
    """The layout's sizes for (graph, ndev), cached on the graph."""
    key = ("geometry", ndev)
    geo = graph._cache.get(key)
    if geo is None:
        v_per_dev = -(-graph.num_vertices // ndev)
        geo = graph._cache[key] = ShardGeometry(
            num_vertices=v_per_dev * ndev,
            num_real_vertices=graph.num_vertices, ndev=ndev,
            v_per_dev=v_per_dev)
    return geo


def device_upload(sg: ShardedGraph, field: str, device) -> torch.Tensor:
    """One ``ShardedGraph`` array (``src_local``/``dst``/``weight``/
    ``deg_w``) on ``device``, cached per (layout, field, device)."""
    key = ("upload", field, str(torch.device(device)))
    t = sg._cache.get(key)
    if t is None:
        t = sg._cache[key] = torch.from_numpy(
            np.ascontiguousarray(getattr(sg, field))).to(device)
    return t


# ---------------------------------------------------------------------------
# One rank's segments on its device
# ---------------------------------------------------------------------------

class RankShard(NamedTuple):
    """One rank's shard on its device: CSRs ``(row_ptr int64 (v_local+1,),
    src int32 local rows, dst int32, w f32)`` over its ``v_local`` rows."""

    rank: int
    ndev: int
    v_local: int
    offset: int                # global id of local row 0
    deg_w: torch.Tensor        # (v_local,) f32, 0 on pad rows
    whole: tuple               # every real edge, dst in the plan's index
    interior: tuple            # interior edges, dst as local ids
    frontier: tuple            # frontier edges, dst in the plan's index


def _csr(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
         rows: int) -> tuple:
    """``(row_ptr, src, dst, w)`` of entries already in CSR order."""
    row_ptr = torch.zeros(rows + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(torch.bincount(src, minlength=rows), 0, out=row_ptr[1:])
    return row_ptr, src, dst, w


def rank_shard(graph: Graph, ndev: int, rank: int, device,
               frontier_dst: Optional[np.ndarray] = None,
               layout: tuple = ("global",)) -> RankShard:
    """Rank ``rank``'s segments of ``graph`` (the padded view a run binds)
    on ``device``, cached on the graph.

    Frontier dst default to global ids (the allgather and delta plans'
    lookup); ``frontier_dst`` replaces them with the plan's index of each
    real frontier entry in order (the halo plans' ``dst_index`` row,
    frontier segment), and the whole shard's interior entries then index
    the lookup's local half by their local ids, as the halo remap does.
    ``layout`` names that index in the cache key.
    """
    device = torch.device(device)
    key = ("rank_shard", ndev, rank, str(device)) + tuple(layout)
    shard = graph._cache.get(key)
    if shard is not None:
        return shard
    vp = graph.num_vertices
    vl = -(-vp // ndev)
    lo, hi = min(rank * vl, vp), min((rank + 1) * vl, vp)
    e0, e1 = int(graph.row_ptr[lo]), int(graph.row_ptr[hi])

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    w = up(graph.weight[e0:e1], np.float32)
    keep = w > 0                         # pads: weight-0 no-ops, dropped
    src = up(graph.src[e0:e1], np.int32)[keep] - lo
    dst = up(graph.dst[e0:e1], np.int32)[keep]
    w = w[keep]
    off = rank * vl
    interior = torch.div(dst, vl, rounding_mode="floor") == rank
    fro = ~interior
    if frontier_dst is None:
        d_fro = dst[fro]
        d_whole = dst
    else:
        d_fro = up(frontier_dst, np.int32)
        if d_fro.numel() != int(fro.sum()):
            raise ValueError("frontier_dst does not match the rank's "
                             "frontier edges")
        d_whole = dst - off
        d_whole[fro] = d_fro
    deg = torch.zeros(vl, dtype=torch.float32, device=device)
    deg[: hi - lo] = up(graph.deg_w[lo:hi], np.float32)
    shard = graph._cache[key] = RankShard(
        rank=rank, ndev=ndev, v_local=vl, offset=off, deg_w=deg,
        whole=_csr(src, d_whole, w, vl),
        interior=_csr(src[interior], dst[interior] - off, w[interior], vl),
        frontier=_csr(src[fro], d_fro, w[fro], vl))
    return shard


def has_rank_shard(graph: Graph, ndev: int, rank: int, device) -> bool:
    """Whether some ``rank_shard`` of (graph, ndev, rank) is on ``device``
    already (the session's upload count)."""
    dev = str(torch.device(device))
    return any(isinstance(k, tuple) and k[:4] == ("rank_shard", ndev, rank,
                                                  dev)
               for k in graph._cache)


# ---------------------------------------------------------------------------
# Communication stats and the host-driven entry points
# ---------------------------------------------------------------------------

def comm_stats(sg: ShardedGraph, cfg,
               options: Optional[engine.EngineOptions] = None,
               graph: Optional[Graph] = None) -> dict:
    """Per-iteration communication volume of the sharded engine: the
    label exchange (``options.label_exchange``, see ``core.comm``) plus the
    reduced (k,) aggregators; ``message_bytes_per_iter`` is the plan's
    static message volume, None for the plans whose volume is measured on
    the device (``PartitionResult.exchanged_bytes``).

    Passing ``graph`` (the graph the runner binds) also resolves the tile
    autotuner, so ``score_backend`` / ``fused_update`` / ``tile_config``
    (the CUDA backend's ``{"warps", "rows", "smem_bytes"}``) are what the
    run launches."""
    from . import comm, metrics
    opts = options if options is not None else engine.EngineOptions()
    if graph is not None:
        opts = engine._autotuned(graph, cfg, opts, ndev=sg.ndev)
    name = opts.resolved_label_exchange(sg.ndev)
    pad = opts.pad == "bucket"
    plan = comm.make_exchange_plan(name, sg, delta_cap=opts.delta_cap,
                                   pad=pad)
    wire = plan.wire_bytes_per_iter()
    stats = {
        "label_exchange": name,
        "overlap": opts.resolved_overlap(sg.ndev),
        "frontier_fraction": metrics.frontier_fraction(sg),
        "message_bytes_per_iter": None if wire is None else int(wire),
        "allgather_bytes_per_iter": int(comm.make_exchange_plan(
            "allgather", sg, pad=pad).wire_bytes_per_iter()),
        "aggregator_bytes_per_iter": int(3 * cfg.k * 4 * sg.ndev),
        "edge_shard_sizes": [int((sg.weight[p] > 0).sum())
                             for p in range(sg.ndev)],
        "score_backend": opts.backend().name,
        "fused_update": opts.resolved_fused_update(),
    }
    tile = engine.tile_config(opts, cfg.k)
    if tile is not None:
        stats["tile_config"] = tile
    if name == "halo":
        stats["halo_padded_bytes_per_iter"] = \
            plan.padded_wire_bytes_per_iter()
    if name == "delta":
        stats["delta_cap"] = plan.cap
    return stats


def make_sharded_step(graph: Graph, cfg, mesh, axis: str = "data",
                      options: Optional[engine.EngineOptions] = None):
    """One LPA iteration on the mesh: ``step(state) -> state`` over a state
    whose labels are the whole padded vector (the same on every rank).
    Built by the engine's one sharded code path with the allgather plan
    and no overlap (a plan's carried state would have to outlive the
    call)."""
    opts = options if options is not None else engine.EngineOptions()
    return engine.make_sharded_runner(graph, cfg, mesh, axis, opts,
                                      single_step=True)


def run_sharded_hostloop(graph: Graph, cfg, mesh, axis: str = "data",
                         init: Optional[np.ndarray] = None,
                         options: Optional[engine.EngineOptions] = None
                         ) -> engine.SpinnerState:
    """Drive the sharded step from the host, one call per iteration with a
    host read of ``halted`` after each: the same trajectory and iteration
    count as ``partition(engine="sharded")``; only the syncing differs."""
    from ..launch.mesh import mesh_device
    from .spinner import prepare_init, resolve_options
    cfg, opts = resolve_options(cfg, options)
    labels, loads, key = prepare_init(graph, cfg, init,
                                      device=mesh_device(mesh))
    v_pad = engine.sharded_v_pad(graph, opts, mesh, axis)
    step = make_sharded_step(graph, cfg, mesh, axis, opts)
    state = engine.init_state(engine.pad_labels(labels, v_pad), loads, key)
    for _ in range(cfg.max_iters):
        state = step(state)
        if bool(state.halted):      # the per-iteration host round-trip
            break
    return state


def partition_distributed(graph: Graph, cfg, mesh, axis: str = "data",
                          init: Optional[np.ndarray] = None,
                          options: Optional[engine.EngineOptions] = None,
                          ) -> Tuple[np.ndarray, dict]:
    """Run sharded Spinner to the halting criterion; returns (labels,
    stats): ``partition(graph, cfg, engine="sharded", mesh=mesh)`` plus the
    per-iteration communication volume (``comm_stats``)."""
    from .spinner import partition, resolve_options
    cfg, opts = resolve_options(cfg, options)
    res = partition(graph, cfg, init=init, record_history=False,
                    engine="sharded", mesh=mesh, axis=axis, options=opts)
    padded, _ = engine.padded_view(graph, opts)
    from ..launch.mesh import mesh_size
    sg = shard_layout(padded, mesh_size(mesh, axis),
                      pad=opts.pad == "bucket")
    stats = dict(comm_stats(sg, cfg, opts), iterations=res.iterations,
                 halted=res.halted, exchanged_bytes=res.exchanged_bytes)
    return res.labels, stats
