"""Sharding rules: parameter/cache/batch trees -> DTensor placements.

The port of ``repro.parallel.rules``, with its own copy of the rule table.
Scheme (mesh axes ("pod",) "data", "model"):
  * FSDP: the contraction-side dim of every large matrix is sharded over
    ("pod","data") -- ZeRO-3-style.
  * TP: head / ffn / expert / vocab dims are sharded over "model".
  * EP: MoE expert dim is sharded over "model" (expert parallelism).
  * Small vectors (norm scales, biases of size d, decay LoRAs, gates) are
    replicated.
Activations: batch over ("pod","data"); KV caches shard heads over "model"
when divisible, else the sequence dim.

A reference ``NamedSharding(mesh, PartitionSpec(...))`` is a
:class:`NamedSharding` here: the same per-dimension axis names
(``spec``) and, from them, one DTensor placement per mesh dimension
(``placements``): ``Shard(i)`` on every mesh axis that names dimension
``i``, ``Replicate()`` on the rest.  Two axes on one dimension split it in
mesh-dimension order, the reference's major-to-minor order.  Every leaf of
the ten architectures divides evenly on the (2, 2), (2, 2, 2) and (16,
16) meshes, and each rank's piece equals the reference's
(``tests/test_torch_parallel.py``).  ``shard_tree`` places a tree by its
shardings (the reference's ``jax.tree.map(jax.device_put, params,
p_sh)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models import common as _common
from .constraints import current_mesh, is_dtensor, placements_for, \
    redistribute

PyTree = Any


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's sharding: the mesh and, per tensor dimension, ``None``, an
    axis name or a tuple of axis names (the reference's PartitionSpec)."""
    mesh: DeviceMesh
    spec: Tuple = ()

    @property
    def placements(self) -> list:
        return placements_for(self.spec, self.mesh)


def _names(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(_names(mesh).index(axis))


def fsdp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    return fsdp_axes(mesh)


def _param_spec(path: str, ndim: int, fsdp) -> Tuple:
    """The spec of one parameter leaf, by path name.

    Leading "stacking" dims (layer/group/period axes) are unsharded; the
    rule applies to the trailing dims."""
    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    def tail(*axes):
        return (*([None] * (ndim - len(axes))), *axes)

    if name == "embed":
        return ("model", fsdp)
    if name == "lm_head":
        return (fsdp, "model")
    if parent in ("attn", "cross"):
        if name in ("wq", "wk", "wv"):
            return tail(fsdp, "model")
        if name == "wo":
            return tail("model", fsdp)
        if name in ("bq", "bk", "bv"):
            return tail("model")
        return tail()
    if name in ("exp_w1", "exp_w3"):         # (L, E, d, fe)
        return tail("model", fsdp, None)
    if name == "exp_w2":                      # (L, E, fe, d)
        return tail("model", None, fsdp)
    if name == "router":
        return tail(fsdp, None)
    if name in ("w1", "w3", "cwk", "wz", "wx", "shared_w1", "shared_w3",
                "wr", "wk", "wv", "wg"):      # (.., d, f|d_in|d)
        return tail(fsdp, "model")
    if name in ("w2", "cwv", "out_proj", "wo", "cwr", "shared_w2"):
        return tail("model", fsdp)
    if name in ("wB", "wC", "wdt", "decay_a"):
        return tail(fsdp, None)
    if name == "conv_w":                      # (.., W, d_in)
        return tail(None, "model")
    if name in ("conv_bias", "gn_scale"):
        return tail("model")
    return tail()                             # norms, mixes, gates: replicate


def _clean(spec) -> Tuple:
    """Empty axis tuples are unsharded dimensions (``None``)."""
    return tuple(None if a in ((), None) else a for a in spec)


def param_shardings(specs: PyTree, mesh: DeviceMesh) -> PyTree:
    fsdp = fsdp_axes(mesh)
    leaves = _common.tree_leaves_with_path(specs)
    return _common.tree_unflatten(specs, [
        NamedSharding(mesh, _clean(_param_spec(p, len(s.shape), fsdp)))
        for p, s in leaves])


def _dp_size(mesh: DeviceMesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= _size(mesh, a)
    return n


def batch_shardings(batch_specs: PyTree, mesh: DeviceMesh) -> PyTree:
    """Token/label/embedding inputs: batch dim over ("pod","data").

    Batch dims not divisible by the dp extent (e.g. global_batch=1
    long-context decode) are replicated."""
    dp, dp_size = batch_axes(mesh), _dp_size(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0 or shape[0] % dp_size != 0:
            return NamedSharding(mesh, (None,) * len(shape))
        return NamedSharding(mesh, _clean((dp, *([None] * (len(shape) - 1)))))

    return _common.tree_map(one, batch_specs)


def _model_size(mesh: DeviceMesh) -> int:
    return _size(mesh, "model") if "model" in _names(mesh) else 1


def cache_shardings(cache_specs: PyTree, mesh: DeviceMesh, batch_size: int
                    ) -> PyTree:
    """KV caches / recurrent states, shape-driven.

    Per leaf: the batch dim is the first dim equal to ``batch_size`` that
    is divisible by the dp size (if none, batch is replicated).  Of the
    remaining dims the LARGEST one divisible by the 'model' size is
    model-sharded: for KV caches that is the sequence dim; for SSM/RWKV
    states it is the head or channel dim."""
    dp, dp_size = batch_axes(mesh), _dp_size(mesh)
    msize = _model_size(mesh)

    def one(leaf):
        shp = tuple(leaf.shape)
        ax: list = [None] * len(shp)
        b_idx = None
        for i, s in enumerate(shp):
            if s == batch_size and s % dp_size == 0:
                b_idx = i
                ax[i] = dp
                break
        cands = [(s, i) for i, s in enumerate(shp)
                 if i != b_idx and s % msize == 0 and s > 1]
        if cands:
            _, m_idx = max(cands)
            ax[m_idx] = "model"
        return NamedSharding(mesh, _clean(ax))

    return _common.tree_map(one, cache_specs)


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def place(x, sharding: NamedSharding) -> torch.Tensor:
    """One tensor (or numpy array) as a DTensor at ``sharding``: every
    rank holds the same full value and keeps its own piece (no
    communication), on the mesh's device."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    t = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
    if is_dtensor(t):
        return redistribute(t, sharding.placements)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else
              torch.device(mesh.device_type))
    return distribute_tensor(t.to(device), mesh, sharding.placements,
                             src_data_rank=None)


def shard_tree(tree: PyTree, shardings: PyTree) -> PyTree:
    """Place every leaf of ``tree`` at its sharding (a tree of
    :class:`NamedSharding` matching ``tree``)."""
    return _common.tree_map(place, tree, shardings)


def constrain_compute(layer_tree: PyTree) -> PyTree:
    """FSDP weight gather point: redistribute a layer's parameter slices
    to their COMPUTE sharding (the storage rule with the fsdp axes
    dropped), so the weights are gathered over the data axes before the
    products.  The identity outside a mesh context and on plain
    tensors."""
    mesh = current_mesh()
    if mesh is None:
        return layer_tree
    leaves = []
    for path, leaf in _common.tree_leaves_with_path(layer_tree):
        if not is_dtensor(leaf) or leaf.ndim < 2:
            leaves.append(leaf)
            continue
        spec = _clean(_param_spec(path, leaf.ndim, ()))
        leaves.append(redistribute(leaf, placements_for(spec,
                                                        leaf.device_mesh)))
    return _common.tree_unflatten(layer_tree, leaves)
