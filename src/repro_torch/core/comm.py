"""Communication plans for the sharded engine (Section 3.3 / Figure 7).

Spinner's Pregel design wins because per-superstep traffic SHRINKS as
labels converge: a vertex only messages its neighbours when it migrates.
This module makes that communication an explicit, pluggable layer of the
sharded LPA engine (``repro_torch.core.engine``):

  * ``build_halo_index`` -- the generic halo-plan construction (numpy):
    given which device owns each edge and the placed id of the edge's
    remote endpoint, the per-pair send lists each owner pushes and a
    remapped per-edge index into ``[local values | received halo]``.
  * ``halo_exchange_start`` / ``halo_exchange_finish`` / ``halo_exchange``
    -- the matching collective: gather the send rows, one
    ``all_to_all_single``, concatenate local + halo into the lookup the
    remapped indices address.
  * ``ExchangePlan`` implementations for the per-iteration label exchange,
    selected by ``EngineOptions.label_exchange``: ``allgather`` (the whole
    label vector, the oracle), ``halo`` (only the boundary labels other
    shards reference), ``halo_delta`` (the halo transport, counting only
    boundary values that changed) and ``delta`` (only labels that changed,
    with a full all-gather when a shard's changes overflow its buffer).
    All four give the same lookup, so the same trajectory.

The engine is SPMD over ``torch.distributed``: every process runs the same
step on its own shard, and the plans' collectives run on the mesh's group
(``comm.group``).  The reference's ``shard_map`` collectives map onto
``all_gather_single`` (``all_gather(tiled=True)``), ``all_to_all_single``
with equal splits (``all_to_all``) and ``all_reduce`` (``psum``); the
axis index is the rank.  ``start_exchange`` issues its collectives with
``async_op=True`` and returns the work handles; ``finish_exchange`` waits
on them, so under the overlap schedule the interior scoring launched
between the halves runs while the collective is in flight (on a CUDA card
NCCL runs on its own stream; gloo on a thread).

Accounting: every plan reports ``wire_bytes`` per iteration, the bytes a
message-passing runtime would put on the wire under that plan, equal to
the reference's, plan for plan; ``comm_stats`` reports the static buffer
sizes beside it.

The delta plan's choice between its compact buffer and the full gather is
the reference's ``lax.cond`` on ``pmax(n_local) <= cap``.  Eager PyTorch
has no device-side branch over collectives, so the port gathers the
shards' change counts and reads their maximum on the host: one 4-byte
device-to-host read per iteration of a delta run (both branches give the
same lookup, and the wire count does not depend on the branch).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


class Comm(NamedTuple):
    """Where a shard's collectives run: the mesh axis's process group, this
    process's rank on it (the shard index) and the shard count."""

    group: object
    rank: int
    ndev: int


def mesh_comm(mesh, axis: str = "data") -> Comm:
    """The ``Comm`` of a mesh axis: its group, this process's rank on it
    and its size."""
    from ..launch.mesh import mesh_group, mesh_rank, mesh_size
    return Comm(group=mesh_group(mesh, axis), rank=mesh_rank(mesh, axis),
                ndev=mesh_size(mesh, axis))


def _all_gather(out: torch.Tensor, inp: torch.Tensor, comm: Comm):
    """Tiled all-gather of equal-size shards into ``out``, asynchronously
    (``all_gather_single`` where this PyTorch has it, the older
    ``all_gather_into_tensor`` otherwise)."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    return fn(out, inp, group=comm.group, async_op=True)


def gather_shards(inp: torch.Tensor, comm: Comm) -> torch.Tensor:
    """``(ndev * n, ...)`` all-gather of this shard's ``(n, ...)`` tensor,
    waited on."""
    out = inp.new_empty((comm.ndev * inp.shape[0],) + tuple(inp.shape[1:]))
    _all_gather(out, inp.contiguous(), comm).wait()
    return out


# ---------------------------------------------------------------------------
# Generic halo-plan construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloIndex:
    """Send lists + remapped per-edge indices for a halo exchange.

    ``ext_idx[e]`` addresses ``concatenate([local_values, halo])`` where
    ``halo`` is the ``(ndev, H)`` result of the all-to-all over the rows of
    ``send_idx[this_device]``: slot ``v_per_dev + p * H + s`` holds the
    ``s``-th value owner ``p`` sent to this device.
    """

    ndev: int
    v_per_dev: int
    halo_size: int             # H: max per-pair halo entries (padding unit)
    true_halo: int             # sum of real (unpadded) halo entries
    send_idx: np.ndarray       # (ndev, ndev, H) int32 local ids owner->needer
    ext_idx: np.ndarray        # (E,) int64 per-edge index into [local | halo]
    send_counts: np.ndarray    # (ndev, ndev) int32 REAL entries per pair


def build_halo_index(edge_owner: np.ndarray, remote_ids: np.ndarray,
                     ndev: int, v_per_dev: int,
                     pad_halo: bool = False) -> HaloIndex:
    """Build the halo plan for edges referencing remote vertex values.

    ``edge_owner`` is the device owning each edge, ``remote_ids`` the placed
    id of each edge's remote endpoint (device p owns ``[p*v_per_dev,
    (p+1)*v_per_dev)``).  ``pad_halo`` buckets the per-pair halo size H so
    it survives boundary-set drift; pad slots send vertex 0's value and no
    edge reads them.
    """
    edge_owner = np.asarray(edge_owner)
    remote_ids = np.asarray(remote_ids)
    remote_owner = remote_ids // v_per_dev

    need = {}                  # (needer q, owner p) -> sorted unique ids
    H = 1
    true_halo = 0
    for q in range(ndev):
        qe = edge_owner == q
        for p in range(ndev):
            if p == q:
                continue
            ids = np.unique(remote_ids[qe & (remote_owner == p)])
            need[(q, p)] = ids
            true_halo += ids.size
            H = max(H, int(ids.size))
    if pad_halo:
        from .graph import shape_bucket
        H = shape_bucket(H, floor=8)

    send_idx = np.zeros((ndev, ndev, H), np.int32)   # [owner p][needer q]
    send_counts = np.zeros((ndev, ndev), np.int32)
    for (q, p), ids in need.items():
        send_idx[p, q, : ids.size] = (ids - p * v_per_dev).astype(np.int32)
        send_counts[p, q] = ids.size

    ext_idx = np.empty(edge_owner.shape[0], np.int64)
    local = remote_owner == edge_owner
    ext_idx[local] = remote_ids[local] - edge_owner[local] * v_per_dev
    for (q, p), ids in need.items():
        sel = (edge_owner == q) & (remote_owner == p)
        if not sel.any():
            continue
        ext_idx[sel] = v_per_dev + p * H + np.searchsorted(ids,
                                                           remote_ids[sel])
    return HaloIndex(ndev=ndev, v_per_dev=v_per_dev, halo_size=H,
                     true_halo=true_halo, send_idx=send_idx, ext_idx=ext_idx,
                     send_counts=send_counts)


def halo_exchange_start(values_local: torch.Tensor,
                        send_idx_dev: torch.Tensor, comm: Comm) -> tuple:
    """Issue the halo collective: ``(values_local, halo, work)``.

    The one copy of the halo wire format: gather the ``(ndev, H)`` send
    rows, one equal-split ``all_to_all_single`` (row q goes to rank q, the
    result's row p came from rank p); ``halo_exchange_finish`` waits and
    assembles the lookup.
    """
    outbox = values_local[send_idx_dev].reshape(-1)
    halo = torch.empty_like(outbox)
    work = dist.all_to_all_single(halo, outbox, group=comm.group,
                                  async_op=True)
    return values_local, halo, work


def halo_exchange_finish(values_local: torch.Tensor, halo: torch.Tensor,
                         work) -> torch.Tensor:
    """Wait for a started exchange; the ``[local | halo]`` lookup."""
    work.wait()
    return torch.cat([values_local, halo])


def halo_exchange(values_local: torch.Tensor, send_idx_dev: torch.Tensor,
                  comm: Comm) -> torch.Tensor:
    """One halo exchange: the ``(v_per_dev + ndev * H,)`` lookup addressed
    by ``HaloIndex.ext_idx``."""
    return halo_exchange_finish(*halo_exchange_start(values_local,
                                                     send_idx_dev, comm))


# ---------------------------------------------------------------------------
# Exchange plans for the sharded LPA engine
# ---------------------------------------------------------------------------

class ExchangePlan:
    """How a shard's local labels become the lookup its edges read.

    Host-side products (built once per (layout, plan)):
      * ``dst_index`` -- the (ndev, E_shard) per-edge index into the plan's
        lookup (global vertex ids for allgather/delta, ``None`` when the
        plan was built from a ``ShardGeometry`` without edge arrays;
        halo-remapped ids for the halo plans);
      * ``device_args(rank, device)`` -- the rank's extra tensors (halo
        send rows, the constant wire-byte scalar).

    Per-iteration methods (on the rank's shard, ``comm`` its group):
      * ``init_aux`` -- the plan's carried state (delta's label mirror,
        halo_delta's previous send vector);
      * ``start_exchange`` -- issue the collectives, return a pending
        value; under the overlap schedule the interior scoring runs next;
      * ``finish_exchange`` -- wait and assemble ``(lookup, aux,
        wire_bytes)``, ``wire_bytes`` a float32 device scalar added to
        ``SpinnerState.exchanged_bytes``;
      * ``exchange`` -- the two halves composed (no overlap).

    ``signature()`` / ``from_signature`` keep the reference's array-free
    identity of a plan (the static ints its methods read).
    """

    name: str
    dst_index: Optional[np.ndarray]

    def signature(self) -> tuple:
        raise NotImplementedError

    @classmethod
    def from_signature(cls, sig: tuple) -> "ExchangePlan":
        raise NotImplementedError

    def device_args(self, rank: int, device) -> tuple:
        return ()

    def wire_bytes_per_iter(self) -> Optional[int]:
        """Static per-iteration message bytes; None = measured on device."""
        raise NotImplementedError

    def init_aux(self, labels_local: torch.Tensor, comm: Comm, *args):
        return ()

    def start_exchange(self, labels_local: torch.Tensor, aux, comm: Comm,
                       *args):
        raise NotImplementedError

    def finish_exchange(self, pending):
        raise NotImplementedError

    def exchange(self, labels_local: torch.Tensor, aux, comm: Comm, *args):
        """One full exchange -- the non-overlapped schedule."""
        return self.finish_exchange(
            self.start_exchange(labels_local, aux, comm, *args))

    def prime(self, labels_local: torch.Tensor, comm: Comm, *args):
        """``(lookup, aux, wire_bytes)`` of the initial labels: ``init_aux``
        plus one regular exchange."""
        aux = self.init_aux(labels_local, comm, *args)
        return self.exchange(labels_local, aux, comm, *args)


def _scalar(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


class AllGatherPlan(ExchangePlan):
    """Full label vector every iteration -- the bit-compatible oracle."""

    name = "allgather"

    def __init__(self, sg):
        self.ndev = sg.ndev
        self.v_pad = sg.num_vertices
        self.dst_index = getattr(sg, "dst", None)

    def signature(self) -> tuple:
        return (self.name, self.ndev, self.v_pad)

    @classmethod
    def from_signature(cls, sig):
        plan = cls.__new__(cls)
        _, plan.ndev, plan.v_pad = sig
        plan.dst_index = None
        return plan

    def device_args(self, rank, device):
        return (_scalar(self.wire_bytes_per_iter(), device),)

    def wire_bytes_per_iter(self) -> int:
        # every device receives the (v_pad - v_per_dev) labels it lacks
        return (self.ndev - 1) * self.v_pad * 4

    def start_exchange(self, labels_local, aux, comm, wire):
        lookup = labels_local.new_empty(self.v_pad)
        return lookup, _all_gather(lookup, labels_local, comm), aux, wire

    def finish_exchange(self, pending):
        lookup, work, aux, wire = pending
        work.wait()
        return lookup, aux, wire


class HaloPlan(ExchangePlan):
    """Boundary labels only: each shard receives exactly the remote
    vertices its edges reference (O(cut) instead of O(V))."""

    name = "halo"

    def __init__(self, sg, pad: bool = False):
        self.ndev = sg.ndev
        self.v_per_dev = sg.v_per_dev
        real = sg.weight.reshape(-1) > 0                 # drop layout padding
        owner = np.repeat(np.arange(sg.ndev), sg.dst.shape[1])[real]
        remote = sg.dst.reshape(-1)[real]
        hidx = build_halo_index(owner, remote, sg.ndev, sg.v_per_dev,
                                pad_halo=pad)
        self.halo_size = hidx.halo_size
        self.true_halo = hidx.true_halo
        self._send_idx = hidx.send_idx
        self._send_counts = hidx.send_counts
        # regroup the remapped indices into the (ndev, E_shard) edge layout;
        # padding edges (weight 0) read slot 0 and contribute nothing
        dst_index = np.zeros(sg.dst.shape, np.int32)
        dst_index.reshape(-1)[real] = hidx.ext_idx.astype(np.int32)
        self.dst_index = dst_index
        # each rank's real frontier entries, in order: the index its
        # frontier CSR reads (core.distributed.rank_shard)
        e = sg.e_interior
        self.frontier_dst = [dst_index[p, e:e + int(n)]
                             for p, n in enumerate(sg.frontier_counts)]

    def signature(self) -> tuple:
        return (self.name, self.ndev, self.v_per_dev, self.halo_size)

    @classmethod
    def from_signature(cls, sig):
        plan = cls.__new__(cls)
        _, plan.ndev, plan.v_per_dev, plan.halo_size = sig
        plan.true_halo = None
        plan.dst_index = plan.frontier_dst = None
        return plan

    def device_args(self, rank, device):
        send = torch.from_numpy(self._send_idx[rank].astype(np.int64))
        return (send.to(device), _scalar(self.true_halo * 4, device))

    def wire_bytes_per_iter(self) -> int:
        return self.true_halo * 4

    def padded_wire_bytes_per_iter(self) -> int:
        """What the equal-split all-to-all physically moves."""
        return self.ndev * (self.ndev - 1) * self.halo_size * 4

    def start_exchange(self, labels_local, aux, comm, send_idx, wire):
        # the all-to-all is issued here; the lookup's assembly waits in
        # finish_exchange, so interior scoring runs while it is in flight
        return halo_exchange_start(labels_local, send_idx, comm), aux, wire

    def finish_exchange(self, pending):
        started, aux, wire = pending
        return halo_exchange_finish(*started), aux, wire


class HaloDeltaPlan(HaloPlan):
    """Changed BOUNDARY values only: the halo transport (bit-identical
    lookup) with the wire counted as 8 bytes (slot + value) per boundary
    value that changed since the last exchange, once per (owner, needer)
    pair it is pushed to.  The aux is the previous send vector,
    bootstrapped uncounted by ``init_aux``."""

    name = "halo_delta"

    def device_args(self, rank, device):
        valid = (np.arange(self.halo_size)[None, :]
                 < self._send_counts[rank][:, None])
        send = torch.from_numpy(self._send_idx[rank].astype(np.int64))
        return (send.to(device),
                torch.from_numpy(valid.astype(np.float32)).to(device))

    def wire_bytes_per_iter(self) -> Optional[int]:
        return None        # measured: depends on per-iteration changes

    def init_aux(self, labels_local, comm, *args):
        return labels_local        # the previous send vector (the mirror)

    def start_exchange(self, labels_local, aux, comm, send_idx, send_valid):
        changed = (labels_local != aux).to(torch.float32)
        count = (changed[send_idx] * send_valid).sum().reshape(1)
        count_work = dist.all_reduce(count, group=comm.group, async_op=True)
        return (halo_exchange_start(labels_local, send_idx, comm),
                labels_local, count, count_work)

    def finish_exchange(self, pending):
        started, aux, count, count_work = pending
        count_work.wait()
        return halo_exchange_finish(*started), aux, count[0] * 8.0


class DeltaPlan(ExchangePlan):
    """Changed labels only: the Figure 7 traffic decay.

    Each shard mirrors the full label vector (the aux) and, per iteration,
    broadcasts only the (index, label) pairs of its vertices that migrated
    since the last exchange, in a capped buffer of ``cap`` entries per
    shard (one all-gather), or the whole label vector when any shard
    changed more than ``cap`` -- both give the same mirror.  The branch is
    decided on the host from the gathered change counts (see the module
    docstring).  ``wire_bytes`` counts 8 bytes per changed label to each of
    the other ``ndev - 1`` shards.
    """

    name = "delta"

    def __init__(self, sg, cap: Optional[int] = None):
        self.ndev = sg.ndev
        self.v_pad = sg.num_vertices
        self.v_per_dev = sg.v_per_dev
        self.dst_index = getattr(sg, "dst", None)
        if cap is None:
            cap = max(1, sg.v_per_dev // 4)
        elif cap < 1:
            raise ValueError(f"delta_cap must be >= 1, got {cap}")
        self.cap = min(int(cap), sg.v_per_dev)

    def signature(self) -> tuple:
        return (self.name, self.ndev, self.v_per_dev, self.v_pad, self.cap)

    @classmethod
    def from_signature(cls, sig):
        plan = cls.__new__(cls)
        _, plan.ndev, plan.v_per_dev, plan.v_pad, plan.cap = sig
        plan.dst_index = None
        return plan

    def wire_bytes_per_iter(self) -> Optional[int]:
        return None            # measured: depends on per-iteration migrations

    def init_aux(self, labels_local, comm, *args):
        return gather_shards(labels_local, comm)

    def start_exchange(self, labels_local, aux, comm, *args):
        vl, v_pad, cap = self.v_per_dev, self.v_pad, self.cap
        off = comm.rank * vl
        changed = labels_local != aux[off:off + vl]
        counts = gather_shards(changed.sum().to(torch.int32).reshape(1), comm)
        wire = counts.sum().to(torch.float32) * float(8 * (self.ndev - 1))
        if int(counts.max()) > cap:      # the host's branch (one read)
            lookup = labels_local.new_empty(v_pad)
            return "full", lookup, _all_gather(lookup, labels_local, comm), \
                wire
        # changed entries first (stable, so in ascending index order);
        # unused slots point one past the mirror and land in a spare slot
        order = torch.sort((~changed).to(torch.int32), stable=True).indices
        idx_l = order[:cap]
        idx_g = torch.where(changed[idx_l], idx_l + off,
                            v_pad).to(torch.int32)
        # one int32 buffer: float values travel bit-cast, so neither the
        # indices nor the values round through float32
        outbox = torch.cat([idx_g, labels_local[idx_l].view(torch.int32)])
        inbox = outbox.new_empty(comm.ndev * 2 * cap)
        return "compact", (aux, inbox), _all_gather(inbox, outbox, comm), \
            wire

    def finish_exchange(self, pending):
        mode, out, work, wire = pending
        work.wait()
        if mode == "full":
            return out, out, wire
        aux, inbox = out
        g = inbox.view(self.ndev, 2, self.cap)
        mirror = torch.cat([aux, aux.new_zeros(1)])
        mirror[g[:, 0].reshape(-1).long()] = \
            g[:, 1].reshape(-1).view(aux.dtype)
        lookup = mirror[:self.v_pad]
        return lookup, lookup, wire


# The one registry of plan names: EngineOptions.resolved_label_exchange
# validates against its keys.
EXCHANGE_PLANS = {
    "allgather": AllGatherPlan,
    "halo": HaloPlan,
    "halo_delta": HaloDeltaPlan,
    "delta": DeltaPlan,
}


def make_exchange_plan(name: str, sg, delta_cap: Optional[int] = None,
                       pad: bool = False) -> ExchangePlan:
    """Build (or fetch from the layout's cache) the named plan.

    ``sg`` is a ``ShardedGraph``, or a ``ShardGeometry`` for the plans that
    read no edge arrays (allgather, delta).  ``delta_cap`` only shapes the
    delta plan and ``pad`` (the bucketed halo size) only the halo plans,
    so each stays out of the other plans' keys.
    """
    if name not in EXCHANGE_PLANS:
        raise ValueError(f"unknown label exchange {name!r}; "
                         f"available: {', '.join(sorted(EXCHANGE_PLANS))}")
    if name == "delta":
        key, build = ((name, delta_cap),
                      lambda: DeltaPlan(sg, cap=delta_cap))
    elif name in ("halo", "halo_delta"):
        key, build = ((name, pad),
                      lambda: EXCHANGE_PLANS[name](sg, pad=pad))
    else:
        key, build = (name,), lambda: EXCHANGE_PLANS[name](sg)
    key = ("plan",) + key
    plan = sg._cache.get(key)
    if plan is None:
        plan = sg._cache[key] = build()
    return plan


def plan_from_signature(sig: tuple) -> ExchangePlan:
    """Array-free plan view (see ``ExchangePlan.signature``)."""
    return EXCHANGE_PLANS[sig[0]].from_signature(sig)
