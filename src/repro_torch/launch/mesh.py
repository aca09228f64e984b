"""Meshes over ``torch.distributed``: the vertex-sharding mesh of the
sharded engine, and the 2-D meshes of the LLM side.

The reference drives every device from one controller (``shard_map`` over a
``jax.sharding.Mesh``).  Here the sharded engine is SPMD: one process per
device, each holding its shard, all in one process group, and the mesh is a
1-D ``torch.distributed.device_mesh.DeviceMesh`` whose one dimension is
named after the reference's vertex axis (``"data"``).  Collectives run on
that dimension's group: NCCL for CUDA tensors, gloo for CPU tensors.  A
CUDA mesh on a group without NCCL is refused: gloo moves no CUDA tensor
without staging it through host memory.

``make_partition_mesh`` without an initialised process group (and with
``num_devices`` 1 or None) brings up a one-rank group on an in-process
``HashStore`` -- no network -- which is the reference's default "1-D mesh
over the local devices" on a host with one card.  With a group it spans
the world: launch one process per card (``torch.multiprocessing`` or
``torchrun``) and call ``torch.distributed.init_process_group`` first.

The LLM side's meshes are 2-D ``("data", "model")`` (3-D with a leading
``"pod"``), with the reference's shapes and names.
``make_production_mesh`` is the TPU pod's ``(16, 16)`` -- or two pods,
``(2, 16, 16)`` -- over 256 (512) processes of the group; on fewer it
raises ``ValueError`` naming how many it needs.  On H100 nodes of 8 cards
joined by NVLink, a 16-wide ``"model"`` axis spans two nodes: its
tensor-parallel collectives cross the network between them.  The shapes
are the reference's all the same: ``launch.dryrun`` holds them on a fake
process group of 256 or 512 ranks.  ``make_host_mesh(model_axis)`` is
``(world // model_axis, model_axis)`` over whatever group exists (one
process brings up the one-rank group, as ``make_partition_mesh`` does).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _one_rank_group(device_type: str) -> None:
    """A world of one process on an in-process store: NCCL serves CUDA
    tensors where this PyTorch has it, gloo the CPU's."""
    if torch.cuda.is_available() and dist.is_nccl_available():
        backend = "cpu:gloo,cuda:nccl"
    elif device_type == "cuda":
        raise RuntimeError("a CUDA mesh needs NCCL, which this PyTorch "
                           "build lacks")
    else:
        backend = "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_partition_mesh(num_devices: Optional[int] = None,
                        axis: str = "data", device=None,
                        devices: Optional[Sequence[int]] = None
                        ) -> DeviceMesh:
    """1-D vertex-sharding mesh for the sharded LPA engine.

    ``partition(g, cfg, engine="sharded", mesh=make_partition_mesh())``
    shards the run over every process of the group, one device each.
    ``device`` is ``None`` (the CUDA card; raises without one) or
    ``"cpu"``.  Asking for more devices than the world holds raises
    ``ValueError``, as does asking for fewer: a mesh spans the group.

    ``devices`` pins an explicit list of ranks of the world instead (the
    reference's explicit device list): the mesh is over the first
    ``num_devices`` of them (all by default), and more than the list holds
    raises ``ValueError``.  Building it creates the subgroup, which is
    collective over the whole world: every rank makes the same call, and a
    rank outside the list gets a mesh it is not a member of
    (``mesh.get_coordinate()`` is ``None``) and must not run on it.
    """
    from ..core.engine import resolve_device   # lazy: engine imports us
    dev_type = resolve_device(device).type
    if devices is not None:
        pool = [int(r) for r in devices]
        if num_devices is not None and num_devices > len(pool):
            raise ValueError(f"need {num_devices} devices, have "
                             f"{len(pool)} in devices={pool}")
        num_devices = len(pool) if num_devices is None else num_devices
        pool = pool[:num_devices]
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(
                f"need {num_devices} devices, have 1: start one process "
                "per device and call torch.distributed.init_process_group "
                "before building a larger mesh")
        _one_rank_group(dev_type)
    world = dist.get_world_size()
    if devices is not None and pool != list(range(world)):
        if len(set(pool)) != len(pool) or not all(
                0 <= r < world for r in pool):
            raise ValueError(f"devices={pool} must be distinct ranks of a "
                             f"world of {world}")
        mesh = DeviceMesh(dev_type, torch.tensor(pool),
                          mesh_dim_names=(axis,))
        if mesh.get_coordinate() is not None:
            mesh_group(mesh, axis)  # a CUDA mesh on a gloo group raises
        return mesh
    n = world if num_devices is None else int(num_devices)
    if n > world:    # not an assert: must survive python -O
        raise ValueError(f"need {n} devices, have {world} processes in the "
                         "group")
    if n != world:
        raise ValueError(f"a partition mesh spans its process group: asked "
                         f"for {n} devices in a world of {world}")
    mesh = init_device_mesh(dev_type, (n,), mesh_dim_names=(axis,))
    mesh_group(mesh, axis)         # a CUDA mesh on a gloo group raises now
    return mesh


def _ensure_group(dev_type: str) -> None:
    """The process group: the one already up; else the one ``torchrun``
    describes in the environment (``WORLD_SIZE`` > 1); else the one-rank
    group."""
    if dist.is_initialized():
        return
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                                init_method="env://")
        if dev_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        return
    _one_rank_group(dev_type)


def _grid_mesh(dev_type: str, shape, names) -> DeviceMesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks of the
    group (the reference's ``devices[:need]``); ranks past them are not
    members."""
    need = math.prod(shape)
    if need == dist.get_world_size():
        return init_device_mesh(dev_type, tuple(shape),
                                mesh_dim_names=tuple(names))
    return DeviceMesh(dev_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> DeviceMesh:
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    ``(2, 16, 16)`` over ``("pod", "data", "model")``, spanning the first
    256 (512) processes of the group.  Raises ``ValueError`` on fewer
    (without a group a process is a world of one)."""
    from ..core.engine import resolve_device   # lazy: engine imports us
    dev_type = resolve_device(device).type
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        _ensure_group(dev_type)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:    # not an assert: must survive python -O
        raise ValueError(
            f"need {need} devices, have {have}; start {need} processes, or "
            f"a fake process group of world size {need} "
            "(python -m repro_torch.launch.dryrun)")
    return _grid_mesh(dev_type, shape, names)


def make_host_mesh(model_axis: int = 1, device=None) -> DeviceMesh:
    """``(world // model_axis, model_axis)`` over ``("data", "model")``
    (tests and small runs) over the process group: the one up, the one
    ``torchrun`` describes, or else the one-rank group."""
    from ..core.engine import resolve_device
    dev_type = resolve_device(device).type
    _ensure_group(dev_type)
    data = dist.get_world_size() // model_axis
    if data < 1:
        raise ValueError(f"need {model_axis} devices for a model axis of "
                         f"{model_axis}, have {dist.get_world_size()}")
    return _grid_mesh(dev_type, (data, model_axis), ("data", "model"))


def mesh_size(mesh: DeviceMesh, axis: str = "data") -> int:
    """The number of devices along ``axis`` (``mesh.shape[axis]`` in the
    reference)."""
    return mesh.size(_dim(mesh, axis))


def mesh_group(mesh: DeviceMesh, axis: str = "data"):
    """The process group of ``axis``, which the collectives run on; raises
    for a CUDA mesh whose group has no NCCL backend."""
    _dim(mesh, axis)
    group = mesh.get_group(axis)
    backend = str(dist.get_backend(group))
    if mesh.device_type == "cuda" and "nccl" not in backend.lower():
        raise ValueError(
            f"a CUDA mesh needs an NCCL group, not {backend!r}: gloo cannot "
            "gather CUDA tensors without staging them through host memory")
    return group


def mesh_rank(mesh: DeviceMesh, axis: str = "data") -> int:
    """This process's index along ``axis`` (``axis_index`` in the
    reference)."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this process's shard lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; axes: {names}")
    return names.index(axis)
