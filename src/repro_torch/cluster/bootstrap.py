"""Multi-process cluster bring-up: the key-value store, meshes, edge shards.

The paper's dynamicity scenario is a partitioner on elastic, unreliable
cloud capacity.  This module stands the capacity up, as the reference's
``repro.cluster.bootstrap`` does, with ``jax.distributed``'s coordination
service replaced by a ``torch.distributed.TCPStore``:

* :func:`bootstrap` connects one process to the store and returns a
  :class:`ClusterHandle`: the control-plane surface every process uses
  (``kv_put`` / ``kv_get`` with deadline slicing, the array helpers,
  ``allreduce_sum``, ``kv_delete``, ``barrier``) and the local and
  process-spanning meshes.

* :func:`write_edge_shards` / :func:`load_edge_shard` are the per-host
  graph loading path, in the reference's file layout (``manifest.json``,
  ``deg_w.npy``, ``shard_<h>.npz`` with keys ``src`` / ``dst`` /
  ``weight``), so either package reads the other's shards.  Owner =
  ``src // v_per_host``, the range partition ``core.distributed
  .shard_graph`` uses, so host ``h``'s file feeds ``shard_graph(view,
  num_hosts, local_only=h, seg_widths=...)`` and gives row ``h`` of the
  full layout byte for byte.

* :func:`spawn_local_worker` starts ``python -m repro_torch.cluster.worker``.

Departures from the reference, each for the store:

* **Who hosts the store.**  The reference's coordinator is worker 0, so
  losing worker 0 loses the coordinator too.  Here the supervisor hosts
  the master ``TCPStore`` (:func:`serve_store`, on port 0 so the OS picks
  a free port and parallel supervisors never race for one) and passes its
  port to the workers, which connect as clients.  Keys are namespaced by
  generation (``g<gen>/...``), as in the reference.
* **Payload cap.**  The store's libuv server refuses a value over 8 MiB,
  and a full-size host slice of labels is 8 MB raw (10.7 MB in the
  reference's base64).  Values travel as raw bytes, split into chunks of
  at most ``CHUNK_BYTES`` under ``<key>/c<i>``; the key itself, written
  last, holds the chunk count, so a reader never sees half a value.
* **Deletion.**  ``delete_key`` deletes one exact key, so a handle keeps
  the keys it wrote, and ``kv_delete(prefix)`` deletes this process's
  keys under ``prefix``: every process collects its own garbage.
* **Leaving.**  The reference's coordinator outlives its clients'
  barrier.  A process here may host the store itself (:func:`serve_store`
  in a process that also joins the cluster), and the store dies with it.
  So ``shutdown`` counts processes out: a peer adds one to ``EXIT_KEY``
  and leaves, the host waits (at most ``rpc_timeout``) until every
  process has counted itself out.  Every peer calls ``shutdown`` only
  after its last ``barrier`` returned, so none then still needs the
  store.
* **Meshes.**  A process drives one device (the port is SPMD), so there
  is no ``devices_per_process`` (the reference's forced host devices) and
  the local mesh is a one-rank mesh; the process-spanning one needs a process
  group, built on the handle's store (gloo on the CPU; NCCL on cards, one
  card a rank).  The cluster worker exchanges through the store instead,
  which works whatever the ranks share: NCCL cannot put two ranks on one
  card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import weakref
from datetime import timedelta
from typing import Callable, Dict, List, Optional

import numpy as np
import torch.distributed as dist

REPO_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the largest piece of a value sent to the store in one ``set``: half the
# libuv server's 8 MiB payload limit
CHUNK_BYTES = 4 << 20
_WHOLE, _CHUNKED = b"v", b"c"
# every process adds one here in ``shutdown``; the last to count itself
# out sets the release key the store's host waits on
EXIT_KEY = "__exit__"

# the stores this process serves, by (host, port); weak, so a store still
# dies with its last reference
_SERVED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


# ---------------------------------------------------------------------------
# Store bring-up + handle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClusterConfig:
    """One process's view of the cluster."""
    coordinator_address: str = "127.0.0.1"
    port: int = 0
    num_processes: int = 1
    process_id: int = 0
    # default timeout for blocking KV reads / barriers (seconds); a dead
    # peer surfaces as a timeout here, raised as PeerLost
    rpc_timeout: float = 60.0
    # blocking reads wait in slices of this length so the handle's
    # ``on_wait`` hook (the worker's heartbeat) fires while a superstep
    # legitimately blocks on a slow peer
    poll_slice: float = 5.0
    # the device of this process's meshes (None: the CUDA card)
    device: Optional[str] = None

    @property
    def coordinator(self) -> str:
        return f"{self.coordinator_address}:{self.port}"


class PeerLost(RuntimeError):
    """A blocking store read timed out, or lost the store -- a peer (or
    the store's host) is presumed dead."""


def serve_store(timeout: float = 300.0,
                host: str = "127.0.0.1") -> dist.TCPStore:
    """The master ``TCPStore`` on a port the OS picks (``.port``); it
    serves for as long as the returned object lives.  A handle of this
    process on that address and port is the store's host (see
    ``ClusterHandle.shutdown``)."""
    store = dist.TCPStore(host, 0, is_master=True, wait_for_workers=False,
                          timeout=timedelta(seconds=timeout))
    _SERVED[(host, store.port)] = store
    return store


def _serves(cfg: ClusterConfig) -> bool:
    """Whether this process serves the store ``cfg`` connects to."""
    return (cfg.coordinator_address, cfg.port) in _SERVED


class ClusterHandle:
    """The live cluster from one process's perspective.

    ``kv_put`` / ``kv_get`` move control-plane values through the store
    (the worker's label slices and (k,) aggregates), ``barrier``
    synchronizes named points, and the mesh accessors build the local
    and the process-spanning meshes.
    """

    def __init__(self, cfg: ClusterConfig, store=None,
                 hosts_store: Optional[bool] = None):
        self.cfg = cfg
        self.store = store
        # the process whose store this is leaves last (``shutdown``);
        # None: it is the host when this process serves ``cfg``'s store
        self.hosts_store = _serves(cfg) if hosts_store is None \
            else hosts_store
        self.process_id = cfg.process_id
        self.num_processes = cfg.num_processes
        # called between blocking-wait slices in kv_get (the worker binds
        # its heartbeat here): a process still polling is alive, however
        # slow its peers are
        self.on_wait: Optional[Callable[[], None]] = None
        self._written: List[str] = []       # keys this process set
        self._group = False                 # global_mesh built the group

    # -- meshes ------------------------------------------------------------

    def local_mesh(self, axis: str = "data"):
        """A one-rank mesh over THIS process's device, on an in-process
        store (the cluster's workers share no process group; after
        ``global_mesh`` a mesh spans that group instead)."""
        from ..launch.mesh import make_partition_mesh
        return make_partition_mesh(1, axis=axis, device=self.cfg.device)

    def global_mesh(self, axis: str = "data"):
        """The mesh over every process of the cluster, on a process group
        built over the handle's store (gloo for ``device="cpu"``, NCCL on
        cards: one card a rank).  Every process makes the call."""
        from ..core.engine import resolve_device
        from ..launch.mesh import make_partition_mesh
        if not dist.is_initialized() and self.num_processes > 1:
            backend = ("gloo" if resolve_device(self.cfg.device).type
                       == "cpu" else "cpu:gloo,cuda:nccl")
            dist.init_process_group(
                backend, store=dist.PrefixStore("pg", self._store()),
                rank=self.process_id, world_size=self.num_processes)
            self._group = True
        return make_partition_mesh(axis=axis, device=self.cfg.device)

    # -- the store ---------------------------------------------------------

    def _store(self):
        if self.store is None:
            raise RuntimeError("no store: a one-process cluster has no "
                               "coordination surface; bootstrap() a "
                               "cluster of more than one process")
        return self.store

    def _set(self, key: str, value: bytes) -> None:
        self._store().set(key, value)
        self._written.append(key)

    def _wait(self, key: str, timeout: Optional[float]) -> None:
        """Block until ``key`` exists: the full budget waited in
        ``poll_slice``-long slices with ``on_wait()`` between them.  A
        lost connection to the store raises ``PeerLost`` at once."""
        store = self._store()
        total = self.cfg.rpc_timeout if timeout is None else timeout
        deadline = time.monotonic() + total
        err: Optional[Exception] = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise PeerLost(f"kv_get({key!r}) timed out after "
                               f"{total}s: {err}") from err
            try:
                store.wait([key], timedelta(
                    seconds=min(self.cfg.poll_slice, remaining)))
                return
            # torch 2.11 and 2.13 alike: a slice that runs out raises
            # DistStoreError ("wait timeout"), a store whose host is gone
            # DistNetworkError ("Failed to recv" / "Broken pipe")
            except dist.DistNetworkError as e:
                raise PeerLost(f"kv_get({key!r}): the store is lost: "
                               f"{e}") from e
            except dist.DistStoreError as e:
                err = e
            if self.on_wait is not None:
                self.on_wait()

    def kv_put_bytes(self, key: str, value: bytes) -> None:
        """Publish ``value`` under ``key``: whole when it fits one
        ``CHUNK_BYTES`` piece, else its pieces first and then the key."""
        if len(value) <= CHUNK_BYTES:
            self._set(key, _WHOLE + value)
            return
        n = -(-len(value) // CHUNK_BYTES)
        for i in range(n):
            self._set(f"{key}/c{i}",
                      value[i * CHUNK_BYTES: (i + 1) * CHUNK_BYTES])
        self._set(key, _CHUNKED + str(n).encode())

    def kv_get_bytes(self, key: str, timeout: Optional[float] = None
                     ) -> bytes:
        """Blocking read of a ``kv_put_bytes`` value (see ``_wait``)."""
        self._wait(key, timeout)
        store = self._store()
        head = store.get(key)
        if head[:1] == _WHOLE:
            return head[1:]
        return b"".join(store.get(f"{key}/c{i}")
                        for i in range(int(head[1:])))

    def kv_put(self, key: str, value: str) -> None:
        self.kv_put_bytes(key, value.encode())

    def kv_get(self, key: str, timeout: Optional[float] = None) -> str:
        """Blocking read with the full ``rpc_timeout`` budget, waited in
        ``poll_slice``-long slices with ``on_wait()`` fired between them,
        so a worker blocked on a slow peer keeps heartbeating and is not
        misdeclared stale; raises ``PeerLost`` when the budget runs out."""
        return self.kv_get_bytes(key, timeout).decode()

    def kv_put_array(self, key: str, arr: np.ndarray) -> None:
        self.kv_put_bytes(key, np.ascontiguousarray(arr).tobytes())

    def kv_get_array(self, key: str, dtype, shape,
                     timeout: Optional[float] = None) -> np.ndarray:
        raw = self.kv_get_bytes(key, timeout)
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()

    def allreduce_sum(self, tag: str, arr: np.ndarray,
                      timeout: Optional[float] = None) -> np.ndarray:
        """Sum ``arr`` across all processes through the store, in process
        order: every process publishes under ``tag/pid`` and reads every
        peer's.  O(world) small messages: control-plane math (the (k,)
        aggregates and the halting scalars), not the O(V) data plane."""
        arr = np.asarray(arr)
        self.kv_put_array(f"{tag}/{self.process_id}", arr)
        total = np.zeros_like(arr)
        for q in range(self.num_processes):
            total = total + self.kv_get_array(
                f"{tag}/{q}", arr.dtype, arr.shape, timeout)
        return np.asarray(total)      # a 0-d sum is a numpy scalar

    def kv_delete(self, prefix: str) -> None:
        """Best-effort delete of the keys THIS process wrote under
        ``prefix`` (an exact key, or a prefix ending in ``/``).  The
        worker collects iteration ``t-1``'s keys once iteration ``t``'s
        allreduce proves every peer is past them, bounding the store to
        O(V) live bytes.  Garbage collection must never kill a worker, so
        this never raises."""
        keep: List[str] = []
        for key in self._written:
            if key == prefix or (prefix.endswith("/")
                                 and key.startswith(prefix)):
                try:
                    self._store().delete_key(key)
                except Exception:     # the store is gone: nothing to free
                    pass
            else:
                keep.append(key)
        self._written = keep

    def barrier(self, name: str, timeout: Optional[float] = None) -> None:
        """Wait until every process has reached ``name``: one counter
        ``add`` each, the last arrival sets the release key."""
        try:
            if self._store().add(f"{name}/count", 1) == self.num_processes:
                self._store().set(f"{name}/done", b"1")
            self._wait(f"{name}/done", timeout)
        except (PeerLost, dist.DistError) as e:
            raise PeerLost(f"barrier({name!r}) timed out: {e}") from e

    def shutdown(self) -> None:
        """Leave the cluster: drop any process group ``global_mesh`` built
        and the connection to the store.  A peer counts itself out under
        ``EXIT_KEY`` and returns at once; the store's host counts itself
        out, then waits until every process has (at most ``rpc_timeout``)
        before it leaves, so its store outlives every peer's last
        ``barrier``.  Never raises."""
        if not self.hosts_store:
            self._leave_group()
        if self.store is not None:
            try:
                if self.store.add(f"{EXIT_KEY}/count", 1) \
                        == self.num_processes:
                    self.store.set(f"{EXIT_KEY}/done", b"1")
                elif self.hosts_store:
                    self._wait(f"{EXIT_KEY}/done", None)
            except (PeerLost, dist.DistError):
                pass        # the store is lost, or a peer never counted out
            self.store = None
        if self.hosts_store:
            self._leave_group()

    def _leave_group(self) -> None:
        if self._group and dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:
                pass
        self._group = False


def bootstrap(cfg: ClusterConfig, store=None,
              hosts_store: Optional[bool] = None) -> ClusterHandle:
    """Connect this process to the cluster's store and return the handle.

    ``store`` is used as given (a test's own store); otherwise a process
    of a cluster of more than one connects a client ``TCPStore`` to
    ``cfg.coordinator``.  A one-process cluster has no store: the worker
    loop needs none at world size 1.  ``hosts_store`` gives the handle's
    role in ``shutdown`` (None: detected, see ``serve_store``)."""
    if store is None and cfg.num_processes > 1:
        store = dist.TCPStore(
            cfg.coordinator_address, cfg.port, is_master=False,
            timeout=timedelta(seconds=cfg.rpc_timeout))
    return ClusterHandle(cfg, store, hosts_store)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# Per-host edge shards (the reference's file layout)
# ---------------------------------------------------------------------------

_MANIFEST = "manifest.json"


def write_edge_shards(graph, directory: str, num_hosts: int) -> dict:
    """Split a graph's directed entries into per-host files::

        <dir>/manifest.json   num_vertices, num_hosts, v_per_host,
                              total_weight, seg widths, per-host counts
        <dir>/deg_w.npy       full (V,) weighted degrees (O(V) state)
        <dir>/shard_<h>.npz   src/dst/weight of the entries owned by h

    The raw (max over hosts) interior / frontier segment widths are
    computed here, while the whole edge list is in one place: the one
    global agreement hosts need to build layout-compatible rows alone.
    """
    os.makedirs(directory, exist_ok=True)
    v_per_host = -(-graph.num_vertices // num_hosts)
    real = graph.weight > 0
    src, dst, w = graph.src[real], graph.dst[real], graph.weight[real]
    owner = src // v_per_host
    frontier = (dst // v_per_host) != owner
    n_int = np.bincount(owner[~frontier],
                        minlength=num_hosts).astype(np.int64)
    n_fro = np.bincount(owner[frontier],
                        minlength=num_hosts).astype(np.int64)
    for h in range(num_hosts):
        sel = owner == h
        np.savez(os.path.join(directory, f"shard_{h}.npz"),
                 src=src[sel].astype(np.int32),
                 dst=dst[sel].astype(np.int32),
                 weight=w[sel].astype(np.float32))
    np.save(os.path.join(directory, "deg_w.npy"),
            np.asarray(graph.deg_w, np.float32))
    manifest = {
        "num_vertices": int(graph.num_vertices),
        "num_hosts": int(num_hosts),
        "v_per_host": int(v_per_host),
        "total_weight": float(graph.total_weight),
        "seg_interior": int(n_int.max()) if n_int.size else 0,
        "seg_frontier": int(n_fro.max()) if n_fro.size else 0,
        "interior_counts": [int(x) for x in n_int],
        "frontier_counts": [int(x) for x in n_fro],
    }
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    return manifest


def read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, _MANIFEST)) as f:
        return json.load(f)


def load_edge_shard(directory: str, host: int):
    """One host's ``EdgeShardView``: its edge file plus the shared O(V)
    degree vector, never the full edge set.  Returns ``(view,
    manifest)``."""
    from ..core.distributed import EdgeShardView
    manifest = read_manifest(directory)
    with np.load(os.path.join(directory, f"shard_{host}.npz")) as z:
        src, dst, weight = z["src"], z["dst"], z["weight"]
    deg_w = np.load(os.path.join(directory, "deg_w.npy"))
    view = EdgeShardView(num_vertices=manifest["num_vertices"], src=src,
                         dst=dst, weight=weight, deg_w=deg_w)
    return view, manifest


def load_local_shard(directory: str, host: int, pad: bool = False):
    """Host ``host``'s one-row ``ShardedGraph`` built from its edge file
    alone (the ``local_only`` path), layout-compatible with every other
    host's row through the manifest's agreed segment widths."""
    from ..core.distributed import shard_graph
    view, manifest = load_edge_shard(directory, host)
    return shard_graph(view, manifest["num_hosts"], pad=pad,
                       local_only=host,
                       seg_widths=(manifest["seg_interior"],
                                   manifest["seg_frontier"]))


# ---------------------------------------------------------------------------
# Local subprocess spawning (tests / the smoke run)
# ---------------------------------------------------------------------------

def worker_env(*, extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Environment for a spawned worker: ``src`` on the path; ``extra``
    entries win."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_SRC + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if extra:
        env.update(extra)
    return env


def spawn_local_worker(*, workdir: str, gen: int, world: int, pid: int,
                       port: int,
                       extra_env: Optional[Dict[str, str]] = None
                       ) -> subprocess.Popen:
    """Spawn one cluster worker process (``python -m
    repro_torch.cluster.worker``) against the store on ``port``; every
    worker reads ``<workdir>/job.json`` and logs to
    ``<workdir>/worker_g<gen>_p<pid>.log``."""
    argv = [sys.executable, "-m", "repro_torch.cluster.worker",
            "--workdir", workdir, "--gen", str(gen),
            "--world", str(world), "--pid", str(pid),
            "--port", str(port)]
    with open(os.path.join(workdir, f"worker_g{gen}_p{pid}.log"),
              "wb") as out:
        return subprocess.Popen(argv, env=worker_env(extra=extra_env),
                                stdout=out, stderr=subprocess.STDOUT)
