"""repro_torch.cluster: the multi-process fault-tolerant partition runtime.

The port of the reference's ``repro.cluster``, on a
``torch.distributed.TCPStore`` in place of ``jax.distributed``:

* :mod:`~repro_torch.cluster.bootstrap` -- the store (hosted by the
  supervisor, workers connect to it), the handle's KV / allreduce /
  barrier surface, the local and process-spanning meshes, and per-host
  edge-shard IO in the reference's file layout;
* :mod:`~repro_torch.cluster.snapshot` -- ``PartitionSession`` state
  through ``repro_torch.ckpt`` (atomic), restorable onto a different
  device count by replaying the elastic ``resize``;
* :mod:`~repro_torch.cluster.supervisor` -- heartbeats, fault hooks
  (worker kill, snapshot corruption, slow worker) and the restart policy;
* :mod:`~repro_torch.cluster.worker` -- the spawnable worker loop (per-host
  shards, K2 scores on the worker's rows, label exchange through the
  store, snapshot cadence);
* :mod:`~repro_torch.cluster.deploy` -- the serving tier's deployment
  mode, ``PartitionScheduler(deployment=ClusterDeployment(...))``.

Same-capacity recovery is bit-identical to an uninterrupted run; a shrunk
capacity resumes through ``resize`` within quality tolerance (both held
in ``tests/test_torch_cluster*.py``).
"""
from .bootstrap import (ClusterConfig, ClusterHandle, PeerLost, bootstrap,
                        free_port, load_edge_shard, load_local_shard,
                        read_manifest, spawn_local_worker, worker_env,
                        write_edge_shards)
from .deploy import ClusterDeployment
from .snapshot import (RestoreInfo, load_snapshot, newest_complete,
                       restore_session, save_snapshot, snapshot_steps,
                       snapshot_tree)
from .supervisor import (ClusterSupervisorConfig, PartitionSupervisor,
                         ProcessClusterConfig, ProcessClusterSupervisor,
                         WorkerLost, corrupt_newest_snapshot_at,
                         kill_worker_at, slow_worker_at)

__all__ = [
    "ClusterConfig", "ClusterHandle", "PeerLost", "bootstrap",
    "free_port", "load_edge_shard", "load_local_shard", "read_manifest",
    "spawn_local_worker", "worker_env", "write_edge_shards",
    "ClusterDeployment",
    "RestoreInfo", "load_snapshot", "newest_complete", "restore_session",
    "save_snapshot", "snapshot_steps", "snapshot_tree",
    "ClusterSupervisorConfig", "PartitionSupervisor",
    "ProcessClusterConfig", "ProcessClusterSupervisor", "WorkerLost",
    "corrupt_newest_snapshot_at", "kill_worker_at", "slow_worker_at",
]
