"""Atomic checkpointing of trees of arrays and tensors.

The port of the reference's ``repro.ckpt.checkpoint``.  Layout:
``<dir>/step_<n>/`` holds one ``.npy`` per leaf plus ``manifest.json``
(the reference writes a msgpack manifest; JSON needs no package the
card's host lacks).  Leaf keys and file names are the reference's: a
leaf's key is its path joined by ``/`` -- dict keys (sorted, as JAX
flattens them), list and tuple indices, and ``.name`` for a NamedTuple
field -- or ``value`` for a bare leaf, and its file is the key with
``/`` replaced by ``__``.  A tree saved by either package has the same
keys and the same ``.npy`` files.

Writes go to a ``step_<n>.tmp`` directory renamed into place, so a crash
mid-save never leaves a partial step; writers sweep crashed half-saves
older than ``TMP_GC_AGE_S``.  On restore each leaf becomes a numpy
array, or a torch tensor where the matching leaf of ``like`` is one or
``device`` is given (the counterpart of the reference's ``shardings=``).

A tree of DTensors (a state placed on a mesh) is saved whole: each leaf
is gathered (collective: every rank of the mesh calls ``save``), rank 0
writes, and every rank waits for the rename.  Restoring into such a tree
gives every leaf back at its ``like`` leaf's placements, so a restart on
the same mesh repeats the run bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any
_MANIFEST = "manifest.json"

# A step_*.tmp directory younger than this may be a concurrent save still
# in flight (tmp written, rename pending); only colder ones are crashed
# half-saves that writers may sweep.
TMP_GC_AGE_S = 300.0


def _gc_stale_tmp(directory: str, age: float = TMP_GC_AGE_S) -> None:
    """Sweep crashed half-saves: ``step_*.tmp`` dirs older than ``age``
    seconds.  Called only from the writer-side paths (:func:`save`,
    :func:`gc_old`): a read must never delete a tmp dir another process
    may be about to rename into place."""
    now = time.time()
    for d in os.listdir(directory):
        if not (d.startswith("step_") and d.endswith(".tmp")):
            continue
        path = os.path.join(directory, d)
        try:
            if now - os.path.getmtime(path) > age:
                shutil.rmtree(path, ignore_errors=True)
        except OSError:
            pass                      # raced with the owner's rename


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: PyTree, path: Tuple[str, ...] = ()
            ) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in JAX's flattening order; ``None`` has no leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [("/".join(path) or "value", tree)]
    out = []
    for name, sub in items:
        out += _leaves(sub, path + (name,))
    return out


def _rebuild(like: PyTree, leaves: list) -> PyTree:
    """``like``'s structure with its leaves taken in order from
    ``leaves`` (consumed from the front)."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return type(like)((k, out[k]) for k in like)
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(x, leaves) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, leaves) for x in like)
    return leaves.pop(0)


def _is_dtensor(x) -> bool:
    from ..parallel.constraints import is_dtensor
    return is_dtensor(x)


def _host(leaf) -> np.ndarray:
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _writer() -> bool:
    """Whether this process writes a mesh-placed tree: rank 0 does."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save(directory: str, step: int, tree: PyTree) -> str:
    """Atomically write the checkpoint of ``step``; returns its path."""
    final = os.path.join(directory, f"step_{step:08d}")
    leaves = _leaves(tree)
    arrays = ((key, _host(leaf)) for key, leaf in leaves)  # leaf by leaf
    if not any(_is_dtensor(leaf) for _, leaf in leaves):
        return _write(directory, final, step, arrays)
    if _writer():
        _write(directory, final, step, arrays)
    else:
        for _ in arrays:          # every rank takes part in the gathers
            pass
    _barrier()
    return final


def _write(directory: str, final: str, step: int, arrays) -> str:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "keys": []}
    for key, arr in arrays:
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["keys"].append({"key": key, "file": fname,
                                 "dtype": str(arr.dtype),
                                 "shape": list(arr.shape)})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc_stale_tmp(directory)
    return final


def latest_step(directory: str) -> Optional[int]:
    """Newest complete step (read-only; ``step_*.tmp`` dirs are skipped:
    the rename IS the commit, so a crash between a save's tmp write and
    its rename leaves no visible step).  Stale tmp dirs are swept by the
    writers, never here."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(directory: str, like: PyTree, step: Optional[int] = None,
            device=None) -> PyTree:
    """Restore into the structure of ``like`` (newest step by default).

    Each leaf comes back as a numpy array, or as a torch tensor where the
    matching leaf of ``like`` is one or ``device`` is given; a tensor goes
    to ``device`` (default: the ``like`` leaf's device).  A directory the
    reference wrote (a msgpack manifest, no ``manifest.json``) restores
    too: its files are named by the same rule."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = os.path.join(path, _MANIFEST)
    if os.path.exists(manifest):
        with open(manifest) as f:
            files = {e["key"]: e["file"] for e in json.load(f)["keys"]}
    else:
        # a reference checkpoint (msgpack manifest): its files follow the
        # same naming rule
        files = {key: key.replace("/", "__") + ".npy"
                 for key, _ in _leaves(like)}
    leaves = []
    for key, leaf in _leaves(like):
        arr = np.load(os.path.join(path, files[key]))
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != want:
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{arr.shape}, expected {want}")
        if _is_dtensor(leaf):
            from torch.distributed.tensor import distribute_tensor
            arr = distribute_tensor(
                torch.from_numpy(arr).to(leaf.to_local().device),
                leaf.device_mesh, leaf.placements, src_data_rank=None)
        elif isinstance(leaf, torch.Tensor) or device is not None:
            to = device if device is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
            arr = torch.from_numpy(arr).to(to)
        leaves.append(arr)
    return _rebuild(like, leaves)


def gc_old(directory: str, keep: int = 3,
           tmp_age: float = TMP_GC_AGE_S) -> None:
    """Delete all but the newest ``keep`` checkpoints, plus any crashed
    half-save tmp dirs older than ``tmp_age`` seconds."""
    if not os.path.isdir(directory):
        return
    _gc_stale_tmp(directory, age=tmp_age)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
