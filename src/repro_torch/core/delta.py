"""On-device delta merge: the ``adapt(edge_updates=...)`` fast path.

Spinner's operational pitch is cheap adaptation -- "efficiently adapts the
partitioning" upon graph changes (Section 3.4) -- but a naive adapt pays a
host-side O(E) rebuild (``graph.add_edges`` -> ``from_edges``) plus an
O(E) re-upload for ANY delta.  This module makes a warm delta cost
O(|delta| log E) on the host and O(|delta|) on the wire:

  * ``DeltaTracker`` -- the host-side pair ledger (numpy, as the
    reference's).  Built once per session graph (the one O(E) cold cost:
    a sorted canonical-pair key index over the base edge list), it folds
    each ``(src, dst)`` batch through the EXACT ``add_edges`` weight
    semantics (Eq. 3 direction counting, including the convention that a
    weight-1 pair stands for its canonical lo->hi direction) and emits the
    per-batch ``BatchPlan``: the symmetric weight-DELTA entries to append,
    the per-vertex degree increments, and the endpoints whose scores
    changed.  Appended entries are PARALLEL edges carrying the weight
    delta; the integer Eq. 3 weights make every score sum exact, so a
    layout holding ``(u, v, 1)`` in the base CSR and ``(u, v, 1)`` in the
    delta is score-for-score bit-identical to a rebuilt layout holding
    ``(u, v, 2)``.
  * ``DeviceDelta`` -- the session's merged device arrays at one device
    (mode ``single_csr``).  The kernels read one contiguous edge range per
    row, so appended entries cannot go into the base CSR's slack; they
    form a second, small CSR segment instead: the occupied delta entries
    sorted by source (``src`` / ``dst`` / ``w``) with their own
    ``(V_pad + 1,)`` row pointer.  The base CSR (the graph's shared upload)
    is never written; ``deg_w`` is the session's own merged copy.  The
    segment's capacity is the edge bucket's slack, ``e_pad - E``: the
    overflow rule of the reference's XLA mode, upon which the session
    falls back to the bit-identical host rebuild.  ``apply_batch``
    uploads only the batch (12 bytes an entry) and runs the engine's
    merge (``engine.merge_delta``): the segment re-sorted by source and
    its row pointer rebuilt on the device, O(slack + V) device work.
  * the sharded mode (``sharded_csr``), one ``DeviceDelta`` per rank of a
    mesh: the same kind of delta CSR over the rank's ``v_per_dev`` rows
    (source as local rows, dst as global ids, the index of the allgather
    and delta plans' lookup) and the rank's own merged ``deg_w``.  Its slot
    accounting is the reference's ``sharded_xla`` rule over
    ``shard_graph(pad=True)``'s segments, kept for every device on every
    rank: a batch overflows when some device's entries exceed the free
    slots of its interior and frontier tails, and the decision is taken on
    the host from the same numpy data on every rank (no collective), so
    every rank falls back together.  Each rank uploads only the entries
    whose source it owns (12 bytes each); the reference scatters the
    whole batch into its ``(ndev, E_shard)`` arrays, so the upload bytes
    differ from its.

The session layer (``repro_torch.core.session``) owns eligibility,
fallback and the oracle contract; this module is mechanism.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..runtime import trace
from .graph import DeviceCSR, Graph


def check_edge_updates(src, dst, num_vertices: int,
                       new_num_vertices: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Validate an ``edge_updates`` batch; returns int32 (src, dst).

    Rejects mismatched lengths, non-integer dtypes, negative ids and ids
    beyond the (possibly grown) vertex count with a clear ``ValueError``
    -- previously these flowed into the CSR build and either failed
    obscurely or silently grew the vertex set.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.ndim != 1 or dst.ndim != 1:
        raise ValueError(
            "edge_updates src/dst must be 1-D index arrays; got shapes "
            f"{src.shape} and {dst.shape}")
    if src.shape[0] != dst.shape[0]:
        raise ValueError(
            f"edge_updates src/dst length mismatch: {src.shape[0]} src "
            f"vs {dst.shape[0]} dst entries")
    for name, a in (("src", src), ("dst", dst)):
        if a.size and not np.issubdtype(a.dtype, np.integer):
            raise ValueError(
                f"edge_updates {name} must be integer vertex ids; got "
                f"dtype {a.dtype}")
    bound = max(int(num_vertices), int(new_num_vertices or 0))
    if src.size:
        lo = int(min(src.min(), dst.min()))
        hi = int(max(src.max(), dst.max()))
        if lo < 0:
            raise ValueError(
                f"edge_updates contain a negative vertex id ({lo})")
        if hi >= bound:
            raise ValueError(
                f"edge_updates reference vertex {hi} but the graph has "
                f"{num_vertices} vertices"
                + ("" if new_num_vertices is None else
                   f" (growing to {new_num_vertices})")
                + "; pass num_vertices to grow the vertex set explicitly")
    return src.astype(np.int32), dst.astype(np.int32)


def coalesce_updates(batches, dedupe: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold queued ``(src, dst)`` edge-update batches into ONE batch
    whose single ``apply_delta`` is bit-identical to applying the
    batches one by one.

    This is the serving tier's request coalescing (``repro.serve``): N
    queued edge-update requests against one graph collapse into a single
    ``apply_delta`` plan -- one scatter, one reconvergence -- instead of
    N.  Exactness needs care because Eq. 3's pair weights canonicalize
    direction: ``add_edges`` (and the tracker mirroring it) stores a
    weight-1 pair as its canonical ``lo->hi`` edge, so re-submitting the
    SAME ``hi->lo`` edge in a LATER batch reads as the reverse direction
    and bumps the pair to weight 2, while re-submitting ``lo->hi`` is a
    no-op.  A plain concatenation dedupes that distinction away.

    The coalesced batch therefore keeps, per canonical pair, the
    direction(s) of the FIRST batch that contributed it, upgraded to
    BOTH directions when any later batch re-contributes the
    reverse-of-canonical direction.  For every prior pair weight (0, 1
    or 2) this reproduces the sequential chain's final weight exactly,
    so scores stay bit-identical (integer-valued f32 sums).  Self-loops
    are dropped (they never count).  With ``dedupe=False`` the batches
    are simply concatenated -- exact only when no pair repeats across
    batches.
    """
    batches = [b for b in batches if b is not None]
    if not batches:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    srcs = [np.asarray(b[0]) for b in batches]
    dsts = [np.asarray(b[1]) for b in batches]
    if not dedupe:
        return np.concatenate(srcs), np.concatenate(dsts)
    nonempty = [(s, d) for s, d in zip(srcs, dsts) if s.size]
    if not nonempty:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    base = max(int(max(s.max(), d.max())) for s, d in nonempty) + 1
    state: dict = {}               # canonical key -> 1 canon | 2 rev | 3
    order: list = []               # canonical keys, first-arrival order
    for s, d in nonempty:
        s = s.astype(np.int64)
        d = d.astype(np.int64)
        keep = s != d
        s, d = s[keep], d[keep]
        if not s.size:
            continue
        lo = np.minimum(s, d)
        hi = np.maximum(s, d)
        uniq, inv = np.unique(lo * base + hi, return_inverse=True)
        has_c = np.zeros(uniq.size, bool)
        has_r = np.zeros(uniq.size, bool)
        np.logical_or.at(has_c, inv, s < d)
        np.logical_or.at(has_r, inv, s > d)
        for k, hc, hr in zip(uniq.tolist(), has_c.tolist(),
                             has_r.tolist()):
            cur = state.get(k)
            if cur is None:
                state[k] = (1 if hc else 0) | (2 if hr else 0)
                order.append(k)
            elif hr and cur != 3:  # a later reverse edge bumps w 1 -> 2
                state[k] = 3
    out_s: list = []
    out_d: list = []
    for k in order:
        lo, hi = divmod(k, base)
        if state[k] & 1:
            out_s.append(lo)
            out_d.append(hi)
        if state[k] & 2:
            out_s.append(hi)
            out_d.append(lo)
    return np.asarray(out_s, np.int64), np.asarray(out_d, np.int64)


@dataclasses.dataclass
class BatchPlan:
    """One batch folded to its append-delta form (see ``DeltaTracker``)."""

    src: np.ndarray        # int32 (2 * changed_pairs,) entries to append
    dst: np.ndarray        # int32, symmetric counterparts interleaved
    dw: np.ndarray         # f32 weight DELTA carried by each entry
    touched: np.ndarray    # int32 unique endpoints of changed pairs
    pair_keys: np.ndarray  # int64 canonical keys of changed pairs
    pair_w: np.ndarray     # f32 NEW total weight of changed pairs
    tw_delta: float        # total_weight change (2 * sum of pair deltas)

    @property
    def num_entries(self) -> int:
        return int(self.src.shape[0])


class DeltaTracker:
    """Host ledger of pair weights across a session's pending deltas.

    ``plan(src, dst)`` is pure; ``commit(plan)`` folds a successfully
    merged batch into the overlay so later batches see it (sequential
    per-batch semantics, matching a chain of ``add_edges`` calls).
    """

    def __init__(self, graph: Graph):
        V = graph.num_vertices
        half = graph.src < graph.dst
        # graph arrays are lexsorted by (src, dst), so the canonical-half
        # keys come out sorted: one O(E) pass, then O(log E) lookups
        self.num_vertices = V
        self.canon_keys = (graph.src[half].astype(np.int64) * V
                           + graph.dst[half])
        self.canon_w = graph.weight[half].astype(np.float64)
        self.pairs: dict = {}          # canonical key -> overlaid weight
        self.total_weight = float(graph.total_weight)

    def _current_w(self, keys: np.ndarray) -> np.ndarray:
        w = np.zeros(keys.size, np.float64)
        if self.canon_keys.size:
            pos = np.searchsorted(self.canon_keys, keys)
            pos_c = np.minimum(pos, self.canon_keys.size - 1)
            found = self.canon_keys[pos_c] == keys
            w[found] = self.canon_w[pos_c[found]]
        for i, key in enumerate(keys):
            ov = self.pairs.get(int(key))
            if ov is not None:
                w[i] = ov
        return w

    def plan(self, src: np.ndarray, dst: np.ndarray) -> BatchPlan:
        V = self.num_vertices
        keep = src != dst                       # self-loops never count
        src, dst = src[keep], dst[keep]
        empty = BatchPlan(
            src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
            dw=np.zeros(0, np.float32), touched=np.zeros(0, np.int32),
            pair_keys=np.zeros(0, np.int64), pair_w=np.zeros(0, np.float32),
            tw_delta=0.0)
        if src.size == 0:
            return empty
        # dedupe directed edges within the batch (from_edges semantics)
        dirkey = np.unique(src.astype(np.int64) * V + dst)
        s = dirkey // V
        d = dirkey % V
        lo = np.minimum(s, d)
        hi = np.maximum(s, d)
        is_canon = s < d
        uniq, inv = np.unique(lo * V + hi, return_inverse=True)
        has_canon = np.zeros(uniq.size, bool)
        has_rev = np.zeros(uniq.size, bool)
        np.logical_or.at(has_canon, inv, is_canon)
        np.logical_or.at(has_rev, inv, ~is_canon)
        w0 = self._current_w(uniq)
        # add_edges reconstructs a weight-1 pair as its canonical lo->hi
        # direction, so: canonical exists iff w0 >= 1, reverse iff w0 == 2
        new_w = (((w0 >= 1) | has_canon).astype(np.float64)
                 + ((w0 >= 2) | has_rev).astype(np.float64))
        change = new_w > w0
        if not change.any():
            return empty
        uniq, w0, new_w = uniq[change], w0[change], new_w[change]
        dw_pair = (new_w - w0).astype(np.float32)
        p_lo = (uniq // V).astype(np.int32)
        p_hi = (uniq % V).astype(np.int32)
        # each changed pair appends BOTH directed entries carrying dw
        e_src = np.stack([p_lo, p_hi], axis=1).reshape(-1)
        e_dst = np.stack([p_hi, p_lo], axis=1).reshape(-1)
        e_dw = np.stack([dw_pair, dw_pair], axis=1).reshape(-1)
        return BatchPlan(
            src=e_src, dst=e_dst, dw=e_dw,
            touched=np.unique(e_src).astype(np.int32),
            pair_keys=uniq, pair_w=new_w.astype(np.float32),
            tw_delta=float(2.0 * dw_pair.sum()))

    def commit(self, plan: BatchPlan) -> None:
        for key, w in zip(plan.pair_keys, plan.pair_w):
            self.pairs[int(key)] = float(w)
        self.total_weight += plan.tw_delta


# ---------------------------------------------------------------------------
# The device-resident delta segment (one device, or one rank of a mesh)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceDelta:
    """The session's merged device arrays at one device (``single_csr``)
    or on one rank of a mesh (``sharded_csr``).

    ``csr`` is the padded base graph's shared upload (read, never
    written; ``None`` on a mesh, whose base is the rank's shard); ``deg_w``
    the merged degrees (this session's own copy); the delta segment is
    ``src`` / ``dst`` / ``w`` (the occupied appended entries, sorted by
    source, stable) with its ``row_ptr`` over the padded vertex set (the
    rank's rows).  ``next_slot`` / ``e_capacity`` are the slot accounting
    of the edge bucket at one device: the first ``E`` slots hold the base
    graph, the rest is slack the delta may fill; on a mesh ``int_fill`` /
    ``fro_fill`` hold it per device, as the reference's sharded layout.
    """

    mode: str                  # single_csr | sharded_csr
    csr: Optional[DeviceCSR]   # single_csr: the padded base upload
    deg_w: torch.Tensor
    src: torch.Tensor          # int32 (used,) (local rows when sharded)
    dst: torch.Tensor          # int32 (used,)
    w: torch.Tensor            # f32 (used,) weight deltas
    row_ptr: torch.Tensor      # int64 (rows + 1,)
    next_slot: int = 0         # base entries + delta entries held
    e_capacity: int = 0        # the edge bucket: base + slack slots
    # --- sharded_csr: this rank, and the slot state of every device ---
    rank: int = 0
    v_per_dev: int = 0
    e_shard: int = 0           # padded row width of shard_graph(pad=True)
    e_interior: int = 0        # its interior segment's width
    int_fill: Optional[np.ndarray] = None  # (ndev,) abs col of int. slack
    fro_fill: Optional[np.ndarray] = None  # (ndev,) abs col of fro. slack

    @property
    def num_entries(self) -> int:
        return int(self.dst.shape[0])


def _empty_segment(deg_w: torch.Tensor, rows: int) -> DeviceDelta:
    """An empty segment of ``rows`` rows with its own copy of ``deg_w``."""
    dev = deg_w.device
    return DeviceDelta(
        mode="single_csr", csr=None, deg_w=deg_w.clone(),
        src=torch.zeros(0, dtype=torch.int32, device=dev),
        dst=torch.zeros(0, dtype=torch.int32, device=dev),
        w=torch.zeros(0, dtype=torch.float32, device=dev),
        row_ptr=torch.zeros(rows + 1, dtype=torch.int64, device=dev))


def init_single_csr(csr: DeviceCSR, num_entries: int) -> DeviceDelta:
    """An empty delta segment over the padded upload ``csr`` of a graph
    with ``num_entries`` real entries; slack = the bucket's tail."""
    dd = _empty_segment(csr.deg_w, csr.deg_w.shape[0])
    return dataclasses.replace(dd, csr=csr, next_slot=int(num_entries),
                               e_capacity=int(csr.dst.shape[0]))


def init_sharded_csr(deg_w: torch.Tensor, rank: int, segments: tuple
                     ) -> DeviceDelta:
    """An empty delta segment over one rank's ``v_per_dev`` rows;
    ``deg_w`` is the rank's base degrees (copied) and ``segments`` the
    padded layout's ``distributed.segment_widths``: the interior slack
    starts after each device's real interior entries, the frontier slack
    after its real frontier entries."""
    n_int, n_fro, e_int, e_shard = segments
    vl = deg_w.shape[0]
    dd = _empty_segment(deg_w, vl)
    return dataclasses.replace(
        dd, mode="sharded_csr", rank=int(rank), v_per_dev=int(vl),
        e_shard=int(e_shard), e_interior=int(e_int),
        int_fill=np.asarray(n_int, np.int64).copy(),
        fro_fill=(int(e_int) + np.asarray(n_fro, np.int64)).copy())


def plan_slots(dd: DeviceDelta, plan: BatchPlan) -> Optional[Callable]:
    """The commit that advances the slot count once a batch is merged, or
    None if the batch would overflow the slack.  Pure: commits nothing.

    Sharded: the reference's ``sharded_xla`` rule -- a device whose new
    entries exceed its free interior plus frontier slots overflows; the
    interior tail fills first."""
    n = plan.num_entries
    if dd.mode == "sharded_csr":
        ndev = dd.int_fill.shape[0]
        counts = np.bincount(plan.src.astype(np.int64) // dd.v_per_dev,
                             minlength=ndev)
        int_avail = dd.e_interior - dd.int_fill
        if np.any(counts > int_avail + (dd.e_shard - dd.fro_fill)):
            return None

        def commit():
            used_int = np.minimum(counts, int_avail)
            dd.int_fill += used_int
            dd.fro_fill += counts - used_int

        return commit
    if dd.next_slot + n > dd.e_capacity:
        return None

    def commit():
        dd.next_slot += n

    return commit


def apply_batch(dd: DeviceDelta, plan: BatchPlan, commit: Callable,
                merge_run: Callable) -> Tuple[DeviceDelta, int]:
    """Merge one planned batch into the device segment.

    ``merge_run`` is the engine's ``merge_delta``.  Returns the updated
    ``DeviceDelta`` (fresh tensors; the old ones are left as they were)
    and the batch upload byte count -- O(|delta|), the transfer the
    session's ``stats()`` counters account.
    """
    host = (plan.src.astype(np.int32), plan.dst.astype(np.int32),
            plan.dw.astype(np.float32))
    if dd.mode == "sharded_csr":
        # this rank's entries only, their sources as local rows
        lo = dd.rank * dd.v_per_dev
        own = (host[0] >= lo) & (host[0] < lo + dd.v_per_dev)
        host = (host[0][own] - np.int32(lo), host[1][own], host[2][own])
    dev = dd.deg_w.device
    with trace.span("delta.merge", n=host[0].size):
        new = tuple(torch.from_numpy(a).to(dev) for a in host)
        src, dst, w, row_ptr, deg_w = merge_run(
            (dd.src, dd.dst, dd.w), new, dd.deg_w)
    commit()
    out = dataclasses.replace(dd, src=src, dst=dst, w=w, row_ptr=row_ptr,
                              deg_w=deg_w, next_slot=dd.next_slot,
                              int_fill=dd.int_fill, fro_fill=dd.fro_fill)
    return out, int(sum(a.nbytes for a in host))


def apply_delta(tracker: DeltaTracker, dd: DeviceDelta, src, dst,
                merge_run: Callable):
    """Plan a ``(src, dst)`` batch against the pair ledger, check the
    slack, merge it into the device segment, and commit the ledger.

    Returns ``(new_dd, plan, uploaded_bytes)``, or ``None`` when the batch
    would overflow the layout's slack (nothing is committed; the caller
    rebuilds from the logical edge list -- bit-identically, because
    appended delta entries carry exact integer weight sums).
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    with trace.span("delta.ledger", n=src.size):
        plan = tracker.plan(src, dst)
    nbytes = 0
    if plan.num_entries:
        commit = plan_slots(dd, plan)
        if commit is None:
            return None
        dd, nbytes = apply_batch(dd, plan, commit, merge_run)
    with trace.span("delta.ledger", n=src.size):
        tracker.commit(plan)
    return dd, plan, nbytes
