"""Activation sharding constraints (mesh-context aware).

The port of ``repro.parallel.constraints``.  Model code calls
``constrain(x, BATCH, None, ...)`` at key activations (embedding output,
logits, the residual stream).  Under a mesh entered with ``with mesh:`` a
DTensor is redistributed to the placements its axes name on that mesh:
``BATCH`` resolves to whichever of ``("pod", "data")`` exist, ``MODEL`` to
``"model"``, ``None`` to an unsharded dimension.  The reference's
``with_sharding_constraint`` steers GSPMD; a redistribution moves the data
then and there.  A plain tensor, or no mesh, passes through untouched, so
every one-device path keeps its numbers bit for bit.

Beside ``constrain`` stand the points where DTensor has no sharding
strategy for what the model does next: ``replicate`` gathers a DTensor
whole on the given mesh axes (a vocab-sharded embedding table or logits,
before the lookup or the cross entropy), ``unshard`` gathers one tensor
dimension (``unshard_middle``: every dimension but the batch and the
features; ``rows`` does it in the backward too).  ``parallel_product``
runs ``dense``'s products Megatron-style on each rank's pieces,
``expert_product`` the MoE's expert-parallel ones.  Both are identities on plain tensors.
``local_map`` runs computations independent across batch rows and heads
(flash attention, the WKV and SSD chunk scans) on each rank's own rows
and heads.  ``mesh_context`` enters a mesh with DTensor's implicit
replication of the plain tensors a model makes.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

BATCH = "__batch__"
MODEL = "__model__"


def current_mesh() -> Optional[DeviceMesh]:
    """The innermost mesh entered with ``with mesh:``, else ``None``.

    A ``DeviceMesh`` is a context manager; PyTorch keeps the stack of
    entered meshes in the private ``device_mesh._mesh_resources``, read
    here and nowhere else."""
    from torch.distributed import device_mesh as dm
    res = getattr(dm, "_mesh_resources", None)
    stack = getattr(res, "mesh_stack", None)
    return stack[-1] if stack else None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _resolve(axis, names: Sequence[str]):
    if axis == BATCH:
        dp = tuple(a for a in ("pod", "data") if a in names)
        return dp if dp else None
    if axis == MODEL:
        return "model" if "model" in names else None
    return axis


def placements_for(spec: Sequence, mesh: DeviceMesh) -> list:
    """One placement per mesh dimension for a per-tensor-dimension spec
    (each entry ``None``, an axis name or a tuple of them): ``Shard(i)``
    on every mesh axis that names dimension ``i``, ``Replicate()`` on the
    rest.  Two axes on one dimension split it in mesh-dimension order,
    the reference's major-to-minor order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            if a in names:
                out[names.index(a)] = Shard(i)
    return out


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Redistribute a DTensor to the placements ``axes`` name on the
    current mesh; the identity on a plain tensor or with no mesh."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x) or len(axes) != x.ndim:
        return x
    names = tuple(mesh.mesh_dim_names or ())
    spec = [_resolve(a, names) for a in axes]
    return redistribute(x, placements_for(spec, x.device_mesh))


def redistribute(x: torch.Tensor, placements) -> torch.Tensor:
    """``x.redistribute(placements)`` unless it is already there."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def replicate(x: torch.Tensor, axes: Optional[Sequence[str]] = None
              ) -> torch.Tensor:
    """A DTensor gathered whole on the mesh axes ``axes`` (all of them by
    default), its other placements kept (a ``Partial`` is summed); the
    identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = tuple(x.device_mesh.mesh_dim_names or ())
    keep = [p if axes is not None and n not in axes else Replicate()
            for n, p in zip(names, x.placements)]
    return redistribute(x, keep)


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor gathered whole along tensor dimension ``dim`` (its other
    placements kept); the identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    return redistribute(x, [Replicate() if isinstance(p, Shard)
                            and p.dim == dim else p for p in x.placements])


def unshard_middle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with only its first (batch) and last (feature) dimension
    left sharded: a product's rows then flatten to a plain batch split
    (DTensor cannot multiply rows split on two mesh axes at once)."""
    if not is_dtensor(x):
        return x
    for d in range(1, x.ndim - 1):
        x = unshard(x, d)
    return x


def split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n * hd) -> (..., n, hd).  On a mesh an axis that splits the
    last dimension but not ``n`` heads evenly gathers it first (DTensor
    cannot unflatten an uneven split); the plain reshape otherwise."""
    if is_dtensor(x) and any(
            getattr(p, "dim", None) == x.ndim - 1
            and n % x.device_mesh.size(j)
            for j, p in enumerate(x.placements)):
        x = unshard(x, x.ndim - 1)
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def parallel_product(fn: Callable, x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fn(x, w, bias)`` -- a product ``x @ w`` (+ ``bias``), ``w`` 2-D --
    on each rank's pieces, Megatron-style, when ``w`` is a DTensor: on the
    data axes ``w`` is gathered whole and ``x``'s rows are split (where
    they divide); on an axis that splits ``w``'s output dimension (column
    parallel) ``x`` is whole and the product split alike; on one that
    splits its input dimension (row parallel, no bias) ``x`` is split on
    its features and the product is a partial sum; elsewhere both are
    whole.  DTensor's own choice, by communication alone, would gather a
    column-parallel ``w`` and repeat the product on every rank.  Plain
    ``w``: ``fn(x, w, bias)``."""
    if not is_dtensor(w):
        return fn(x, w, bias)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh
    R = Replicate()
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [R] * mesh.ndim, run_check=False)
    names = tuple(mesh.mesh_dim_names or ())
    dp = [j for j, n in enumerate(names) if n in ("pod", "data")]
    dp_size = 1
    for j in dp:
        dp_size *= mesh.size(j)
    by_rows = x.shape[0] % dp_size == 0
    xl = x.ndim - 1
    # per mesh dim: (x, w, bias, out) placements and x's, w's, bias's
    # gradient placements
    xp, wp, bp, op, xg, wg, bg = ([] for _ in range(7))
    for j, pw in enumerate(w.placements):
        if j in dp:
            row = Shard(0) if by_rows else R
            xp.append(row), wp.append(R), bp.append(R), op.append(row)
            xg.append(row)
            wg.append(Partial() if by_rows else R)
            bg.append(Partial() if by_rows else R)
        elif isinstance(pw, Shard) and pw.dim == 1:            # column
            xp.append(R), wp.append(Shard(1)), bp.append(Shard(0))
            op.append(Shard(xl)), xg.append(Partial())
            wg.append(Shard(1)), bg.append(Shard(0))
        elif isinstance(pw, Shard) and pw.dim == 0 and bias is None:  # row
            xp.append(Shard(xl)), wp.append(Shard(0)), bp.append(R)
            op.append(Partial()), xg.append(Shard(xl))
            wg.append(Shard(0)), bg.append(R)
        else:
            for acc in (xp, wp, bp, op, xg, wg, bg):
                acc.append(R)
    x = unshard_middle(x)
    xl_t = redistribute(x, xp).to_local(grad_placements=xg)
    wl_t = redistribute(w, wp).to_local(grad_placements=wg)
    bl_t = None
    if bias is not None:
        if not is_dtensor(bias):
            bias = DTensor.from_local(bias, mesh, [R] * mesh.ndim,
                                      run_check=False)
        bl_t = redistribute(bias, bp).to_local(grad_placements=bg)
    out = fn(xl_t, wl_t, bl_t).contiguous()
    shape = (*x.shape[:-1], w.shape[-1])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(out, mesh, op, run_check=False, shape=shape,
                              stride=stride)


def expert_product(fn: Callable, x: torch.Tensor, w: torch.Tensor
                   ) -> torch.Tensor:
    """``fn(x, w)`` -- the experts' batched product (E, C, K) @ (E, K, N)
    -- on each rank's pieces when ``w`` is a DTensor: on an axis that
    splits the experts (expert parallel) ``x`` and the product are split
    alike; on the data axes ``w`` is gathered whole and the buffer slots
    ``C`` are split (where they divide); elsewhere both are whole.
    Plain ``w``: ``fn(x, w)``."""
    if not is_dtensor(w):
        return fn(x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh
    R = Replicate()
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [R] * mesh.ndim, run_check=False)
    names = tuple(mesh.mesh_dim_names or ())
    dp = [j for j, n in enumerate(names) if n in ("pod", "data")]
    dp_size = 1
    for j in dp:
        dp_size *= mesh.size(j)
    by_slots = x.shape[1] % dp_size == 0
    xp, wp, wg = [], [], []
    for j, pw in enumerate(w.placements):
        if j in dp:
            xp.append(Shard(1) if by_slots else R), wp.append(R)
            wg.append(Partial() if by_slots else R)
        elif isinstance(pw, Shard) and pw.dim == 0:
            xp.append(Shard(0)), wp.append(Shard(0)), wg.append(Shard(0))
        else:
            xp.append(R), wp.append(R), wg.append(R)
    out = fn(redistribute(x, xp).to_local(grad_placements=xp),
             redistribute(w, wp).to_local(grad_placements=wg)).contiguous()
    shape = (*x.shape[:-1], w.shape[-1])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(out, mesh, xp, run_check=False, shape=shape,
                              stride=stride)


class _PinGrad(torch.autograd.Function):
    """The identity whose backward gives the gradient the forward value's
    placements, a partial sum read as whole."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Partial, Replicate
        ctx.placements = [Replicate() if isinstance(p, Partial) else p
                          for p in x.placements]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return redistribute(g, ctx.placements) if is_dtensor(g) else g


def rows(x: torch.Tensor) -> torch.Tensor:
    """``unshard_middle(x)``, with the gradient that flows back through
    this point brought to the same placements: a product's rows stay a
    plain batch split, and its output's gradient keeps the output's
    layout (column or row parallel), whatever layout the later ops'
    gradients take.  The identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    return _PinGrad.apply(unshard_middle(x))


def local_map(fn: Callable, args: Sequence, dims: Sequence,
              out_dims: Sequence, heads: Optional[int] = None,
              replicate_heads: bool = False):
    """``fn`` on each rank's batch rows and heads of the DTensor ``args``.

    ``dims[i]`` is ``(batch_dim, head_dim)`` of ``args[i]`` (either may be
    ``None``; a non-tensor argument takes ``None``).  The batch is split
    over the data axes where they divide it, the heads over ``"model"``
    where it divides ``heads`` and ``replicate_heads`` is off; every other
    mesh axis holds the arguments whole.  ``fn`` gets the local tensors
    and returns a tensor or a tuple; ``out_dims`` gives each output's
    ``(batch_dim, head_dim)``.  For computations independent across batch
    rows and heads (attention, the recurrent scans) whose loops and
    in-place accumulators have no DTensor strategy.  Autograd flows
    through; without a DTensor among ``args`` this is ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
    dp_size = 1
    for i in dp:
        dp_size *= mesh.size(i)
    n_rows = next((a.shape[d[0]] for a, d in zip(args, dims)
                   if d is not None and d[0] is not None), None)
    by_rows = n_rows is not None and n_rows % dp_size == 0
    by_heads = (heads is not None and "model" in names
                and not replicate_heads
                and heads % mesh.size(names.index("model")) == 0)

    def place(d):
        b, h = d if d is not None else (None, None)
        return [Shard(b) if i in dp and b is not None and by_rows
                else Shard(h) if n == "model" and h is not None
                and by_heads else Replicate()
                for i, n in enumerate(names)]

    def grad_place(d):
        # an argument whole on an axis that splits the work gets a partial
        # gradient from each rank: summed over that axis
        b, h = d if d is not None else (None, None)
        return [Partial() if (i in dp and b is None and by_rows) or (
            n == "model" and h is None and by_heads) else p
            for i, (n, p) in enumerate(zip(names, place(d)))]

    local = []
    for a, d in zip(args, dims):
        if is_dtensor(a):
            a = redistribute(a, place(d)).to_local(
                grad_placements=grad_place(d))
        elif isinstance(a, torch.Tensor) and d is not None and any(
                isinstance(p, Shard) for p in place(d)):
            from torch.distributed.tensor import distribute_tensor
            a = distribute_tensor(a, mesh, place(d),
                                  src_data_rank=None).to_local()
        local.append(a)
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(DTensor.from_local(t.contiguous(), mesh, place(d),
                                       run_check=False)
                    for t, d in zip(outs, out_dims))
    return wrapped if isinstance(out, tuple) else wrapped[0]


@functools.lru_cache(maxsize=None)
def register_out_dtype_products() -> bool:
    """Give ``aten.mm.dtype`` and ``aten.bmm.dtype`` (a bf16 product with
    a float32 result, ``models.common.matmul_f32`` on the card) the
    sharding strategies of ``mm`` and ``bmm``; DTensor registers none.
    Returns whether they are registered."""
    try:
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import register_sharding
        aten = torch.ops.aten
        mm, bmm = aten.mm.dtype, aten.bmm.dtype
    except (ImportError, AttributeError):
        return False
    R, P, S = Replicate(), Partial(), Shard

    @register_sharding(mm)
    def _mm(a, b, out_dtype):             # (M, K) @ (K, N)
        return [([R], [R, R, None]), ([S(0)], [S(0), R, None]),
                ([S(1)], [R, S(1), None]), ([P], [S(1), S(0), None])]

    @register_sharding(bmm)
    def _bmm(a, b, out_dtype):            # (B, M, K) @ (B, K, N)
        return [([R], [R, R, None]), ([S(0)], [S(0), S(0), None]),
                ([S(1)], [S(1), R, None]), ([S(2)], [R, S(2), None]),
                ([P], [S(2), S(1), None])]

    return True


def mesh_context(mesh: Optional[DeviceMesh]):
    """``with mesh:`` plus DTensor's implicit replication of the plain
    tensors a model makes (positions, masks, zero carries), identical on
    every rank; a null context for ``None``."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(mesh)
    stack.enter_context(implicit_replication())
    return stack
