"""Cluster deployment mode for the serving tier.

The reference's ``repro.cluster.deploy``.
``PartitionScheduler(deployment=ClusterDeployment(...))`` turns the
multi-tenant scheduler into a supervised runtime: every admitted tenant
is pinned to the deployment's (possibly process-spanning) mesh,
snapshotted through ``repro_torch.cluster.snapshot``
after every ``snapshot_every``-th committed dispatch, and -- when a
dispatch raises -- recovered from its newest complete snapshot and
retried ONCE, supervisor-style, with zero operator intervention:

* the recovery graph is the failed session's materialized logical graph
  (base + every accepted delta batch, including the failed window's),
  so the retry runs a plain reconvergence instead of re-applying
  deltas;
* the restore capacity is the deployment's CURRENT mesh -- if capacity
  shrank since the snapshot (``deployment.mesh`` reassigned, e.g. by a
  process supervisor after worker loss), ``restore_session`` replays
  the elastic ``resize`` (partitions/device preserved) before the
  retry.

Tenants with no snapshot yet (first ``partition`` failed) fall through
to the scheduler's normal ticket-failure path.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

from . import snapshot as _snapshot


class ClusterDeployment:
    """Mesh pinning + snapshot/recovery policy for scheduler tenants.

    ``mesh=None`` leaves tenants on their own options (single-device
    sessions still get snapshot/recovery); pass a mesh from
    ``ClusterHandle.local_mesh()`` / ``global_mesh()`` (or
    ``launch.mesh.make_partition_mesh(devices=...)``) to pin every
    tenant's sharded runs to it.  Reassigning ``deployment.mesh``
    between rounds models a capacity change: the next recovery restores
    onto the new width.
    """

    def __init__(self, snapshot_root: str, *, mesh=None, axis: str = "data",
                 snapshot_every: int = 1, keep: int = 3,
                 scale_k: bool = True):
        self.snapshot_root = snapshot_root
        self.mesh = mesh
        self.axis = axis
        self.snapshot_every = max(1, snapshot_every)
        self.keep = keep
        self.scale_k = scale_k
        self.snapshots_written = 0
        self.recoveries = 0
        self.recovery_failures = 0
        self.resized_recoveries = 0
        self.k_roll_forwards = 0
        self.snapshot_errors = 0
        self._commits: Dict[str, int] = {}
        # last COMMITTED k per tenant: with snapshot_every > 1 a
        # committed resize() may postdate the newest snapshot, and a
        # recovery restoring that snapshot must roll k forward again
        # instead of silently reverting the tenant
        self._committed_k: Dict[str, int] = {}

    # -- admission ---------------------------------------------------------

    def admit(self, name: str, options):
        """Tenant options with the deployment mesh pinned (a tenant that
        brought its own mesh keeps it)."""
        from ..core.engine import EngineOptions
        opts = options if options is not None else EngineOptions()
        if self.mesh is not None and opts.mesh is None:
            opts = dataclasses.replace(opts, mesh=self.mesh,
                                       axis=self.axis)
        return opts

    def tenant_dir(self, name: str) -> str:
        return os.path.join(self.snapshot_root, name)

    @property
    def ndev(self) -> int:
        if self.mesh is None:
            return 1
        from ..launch.mesh import mesh_size
        return mesh_size(self.mesh, self.axis)

    # -- snapshot cadence --------------------------------------------------

    def after_commit(self, name: str, session) -> None:
        """Called by the scheduler after each committed dispatch; writes
        the tenant's snapshot on cadence.  Never raises into the serving
        loop -- a failed save is counted and the previous snapshot
        stands (it is complete by construction: atomic rename)."""
        n = self._commits.get(name, 0) + 1
        self._commits[name] = n
        self._committed_k[name] = int(session.cfg.k)
        if n % self.snapshot_every or session.labels is None:
            return
        try:
            _snapshot.save_snapshot(self.tenant_dir(name), session, n,
                                    ndev=self.ndev, keep=self.keep)
            self.snapshots_written += 1
        except Exception:
            self.snapshot_errors += 1

    # -- recovery ----------------------------------------------------------

    def recover(self, name: str, graph, options=None, *,
                roll_forward_k: bool = True):
        """A fresh session for tenant ``name`` restored from its newest
        complete snapshot onto the CURRENT capacity, or None when no
        snapshot exists (the caller then fails the window normally).

        With ``snapshot_every > 1`` the snapshot may predate a
        committed ``resize()``; unless ``roll_forward_k`` is off (the
        scheduler turns it off when the retried window is itself a
        resize, which sets k anyway), the restored session is resized
        back to the tenant's last committed k -- rescaled like any
        snapshot k when capacity changed -- so a recovery never
        silently reverts a committed resize."""
        try:
            info = _snapshot.restore_session(
                self.tenant_dir(name), graph,
                options=self.admit(name, options),
                ndev=self.ndev, scale_k=self.scale_k)
        except FileNotFoundError:
            self.recovery_failures += 1
            return None
        self.recoveries += 1
        if info.resized:
            self.resized_recoveries += 1
        committed = self._committed_k.get(name)
        if roll_forward_k and committed is not None:
            want = committed
            if self.scale_k and info.ndev != info.saved_ndev:
                want = max(1, round(committed * info.ndev
                                    / info.saved_ndev))
            if want != info.k:
                info.result = info.session.resize(want,
                                                  record_history=False)
                info.k = want
                info.resized = True
                self.k_roll_forwards += 1
        return info

    def stats(self) -> dict:
        return {
            "ndev": self.ndev,
            "snapshot_every": self.snapshot_every,
            "snapshots_written": self.snapshots_written,
            "snapshot_errors": self.snapshot_errors,
            "recoveries": self.recoveries,
            "resized_recoveries": self.resized_recoveries,
            "k_roll_forwards": self.k_roll_forwards,
            "recovery_failures": self.recovery_failures,
            "tenants_snapshotted": len(self._commits),
        }
