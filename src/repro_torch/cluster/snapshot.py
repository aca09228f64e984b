"""Checkpointed PartitionSession state, restorable onto different capacity.

The reference's ``repro.cluster.snapshot`` on ``repro_torch.ckpt``: one
checkpoint per snapshot, so writes are atomic (tmp dir + rename; a crash
mid-save never corrupts the newest complete snapshot, and the next writer
sweeps the stale tmp).  The leaf keys and ``.npy`` file names are the
reference's; the manifest is ``manifest.json`` (the reference's is
msgpack)::

    <dir>/step_<n>/            n = work items (or iterations) completed
        labels.npy             (V,) int32 previous stable assignment
        loads.npy              (k,) f32 loads those labels imply
        rng_key.npy            (2,) uint32 -- PRNGKey(cfg.seed), for audit
        runs.npy               int64 session run counter
        delta_watermark.npy    int64 delta batches the labels reflect
        k.npy / num_vertices.npy     int64 cross-checks
        ndev.npy               int64 device count at save time
        cfg__*.npy             SpinnerConfig scalars (see _CFG_FIELDS);
                               migration_weighting stored as an index
        snap_version.npy       format version

Restore (:func:`restore_session`) opens a fresh session on the rebuilt
graph with the SAVED config and imports the labels.  If the restore
capacity differs from ``ndev`` at save, the elastic path replays: k is
rescaled proportionally (partitions per device kept) and
``session.resize(k_new)`` runs Eq. 10's relabel plus one reconvergence.
Same-capacity restores run nothing: a session run is a deterministic
function of (graph, cfg, previous labels), so the continuation is
bit-identical to an uninterrupted run.

A corrupt snapshot (a fault hook deleted its manifest, or a real torn
directory) fails to read and is skipped: :func:`newest_complete` walks the
steps newest first and returns the first that loads.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..ckpt import checkpoint

SNAP_VERSION = 1
MANIFEST = "manifest.json"

# SpinnerConfig scalars a snapshot carries; enums stored as indices
_CFG_FIELDS = ("c", "eps", "halt_window", "max_iters", "seed",
               "tie_noise", "current_bonus")
_WEIGHTINGS = ("edges", "vertices")


def _mesh_ndev(options) -> int:
    """The mesh width of ``options`` (1 without a mesh)."""
    if options is None or getattr(options, "mesh", None) is None:
        return 1
    from ..launch.mesh import mesh_size
    return mesh_size(options.mesh, options.axis)


def snapshot_tree(session, *, ndev: int) -> dict:
    """The flat tree :func:`save_snapshot` writes: the session's
    ``export_state()`` plus the config scalars and the save-time device
    count (what an elastic restore compares against)."""
    tree = session.export_state()
    cfg = session.cfg
    for f in _CFG_FIELDS:
        tree[f"cfg__{f}"] = np.float64(getattr(cfg, f))
    tree["cfg__migration_weighting"] = np.int64(
        _WEIGHTINGS.index(cfg.migration_weighting))
    tree["ndev"] = np.int64(ndev)
    tree["snap_version"] = np.int64(SNAP_VERSION)
    return tree


def save_snapshot(directory: str, session, step: int, *,
                  ndev: Optional[int] = None,
                  keep: Optional[int] = None) -> str:
    """Atomically write the session's state as snapshot ``step``.

    ``ndev`` defaults to the session's mesh width (1 off a mesh); ``keep``
    garbage-collects all but the newest ``keep`` snapshots."""
    if ndev is None:
        ndev = _mesh_ndev(session.options)
    path = checkpoint.save(directory, step, snapshot_tree(session,
                                                          ndev=ndev))
    if keep is not None:
        checkpoint.gc_old(directory, keep=keep)
    return path


def snapshot_steps(directory: str) -> List[int]:
    """All complete snapshot steps, ascending (tmp dirs excluded)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def load_snapshot(directory: str, step: int) -> dict:
    """Read one snapshot's flat tree (raises on a corrupt or missing one).

    Reads the checkpoint layout directly (manifest, then one ``.npy`` a
    key) because the leaf shapes (V, k) are not known before reading,
    which ``checkpoint.restore``'s ``like=`` needs."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    tree = {}
    for entry in manifest["keys"]:
        arr = np.load(os.path.join(path, entry["file"]))
        if tuple(arr.shape) != tuple(entry["shape"]):
            raise IOError(f"snapshot {path} corrupt: {entry['key']} has "
                          f"shape {arr.shape}, manifest says "
                          f"{entry['shape']}")
        tree[entry["key"]] = arr
    missing = {"labels", "loads", "k", "ndev"} - tree.keys()
    if missing:
        raise IOError(f"snapshot {path} corrupt: missing {sorted(missing)}")
    return tree


def newest_complete(directory: str, step: Optional[int] = None,
                    on_corrupt: Optional[Callable[[int, Exception], None]]
                    = None) -> Tuple[int, dict]:
    """The newest snapshot (at most ``step``) that actually loads, walking
    back past corrupt ones (``on_corrupt(step, err)`` observes each skip).
    Raises ``FileNotFoundError`` when none survives."""
    steps = snapshot_steps(directory)
    if step is not None:
        steps = [s for s in steps if s <= step]
    for s in reversed(steps):
        try:
            return s, load_snapshot(directory, s)
        except (OSError, ValueError, KeyError, EOFError) as e:
            if on_corrupt is not None:
                on_corrupt(s, e)
    raise FileNotFoundError(f"no complete snapshot in {directory}")


def decode_cfg(tree: dict):
    """The SpinnerConfig the snapshot was taken under."""
    from ..core.spinner import SpinnerConfig
    kw = {
        "k": int(tree["k"]),
        "halt_window": int(tree["cfg__halt_window"]),
        "max_iters": int(tree["cfg__max_iters"]),
        "seed": int(tree["cfg__seed"]),
        "migration_weighting": _WEIGHTINGS[
            int(tree["cfg__migration_weighting"])],
    }
    for f in ("c", "eps", "tie_noise", "current_bonus"):
        kw[f] = float(tree[f"cfg__{f}"])
    return SpinnerConfig(**kw)


@dataclasses.dataclass
class RestoreInfo:
    """What :func:`restore_session` did."""
    session: object
    step: int                      # snapshot step restored
    saved_ndev: int                # capacity at save time
    ndev: int                      # capacity restored onto
    k_saved: int
    k: int                         # k after any elastic rescale
    resized: bool                  # True: resize() replayed on restore
    result: object = None          # the resize reconvergence result
    corrupt_skipped: int = 0


def restore_session(directory: str, graph, *, options=None,
                    ndev: Optional[int] = None, k: Optional[int] = None,
                    step: Optional[int] = None,
                    scale_k: bool = True) -> RestoreInfo:
    """Rebuild a live session from the newest complete snapshot.

    ``graph`` is the durable graph at (or past) the snapshot's delta
    watermark, rebuilt from edge shards or base inputs: snapshots never
    carry O(E) state.  ``ndev`` is the capacity restored onto (default:
    the width of ``options.mesh``, else 1).  When it differs from the
    save-time capacity and ``scale_k`` is set, k rescales proportionally
    (partitions per device kept, at least 1) and the elastic ``resize``
    replays.  ``k=`` pins the target instead.
    """
    from ..core.session import PartitionSession
    skipped: List[int] = []
    s, tree = newest_complete(directory, step,
                              on_corrupt=lambda st, e: skipped.append(st))
    cfg = decode_cfg(tree)
    if ndev is None:
        ndev = _mesh_ndev(options)
    saved_ndev = int(tree["ndev"])
    session = PartitionSession(graph, cfg, options)
    session.import_state(tree)
    k_target = k
    if k_target is None:
        k_target = cfg.k
        if scale_k and ndev != saved_ndev:
            k_target = max(1, round(cfg.k * ndev / saved_ndev))
    result, resized = None, False
    if k_target != cfg.k:
        result = session.resize(k_target, record_history=False)
        resized = True
    return RestoreInfo(session=session, step=s, saved_ndev=saved_ndev,
                       ndev=ndev, k_saved=cfg.k, k=k_target,
                       resized=resized, result=result,
                       corrupt_skipped=len(skipped))
