"""Shared model building blocks (the port of ``repro.models.common``).

Parameters are nested dicts of tensors keyed exactly as the reference's
pytree, with the stacked leading ``L`` axis of the layers kept.  Each model
module defines ``param_specs(cfg)`` returning the same tree with
:class:`ParamSpec` leaves -- a shape and a dtype, nothing allocated -- which
drives real initialization and parameter counts of any size.

Compute policy, as the reference's: parameters are stored float32 and cast
to bfloat16 at use; a product rounds its bf16 operands' float32
accumulation to bf16 once (``dense``), and scores that the reference keeps
in float32 (``preferred_element_type=float32``) come from
:func:`matmul_f32`.  On the card, :func:`use_reference_numerics` turns off
cuBLAS's bf16 split-K partial sums, which would round before the end.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, List, Tuple

import torch
import torch.nn.functional as F

from ..parallel.constraints import (is_dtensor, parallel_product,
                                    redistribute,
                                    register_out_dtype_products, unshard)

PyTree = Any
COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A leaf's shape and dtype (the reference's ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype = PARAM_DTYPE


def spec(*shape, dtype=PARAM_DTYPE) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), dtype)


# --------------------------------------------------------------------------
# trees: dicts (sorted keys, as JAX flattens them), NamedTuples, lists and
# tuples are nodes; anything else (a tensor, a ParamSpec, None) is a leaf.

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def tree_leaves_with_path(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` in JAX's flattening order; paths join keys by ``/``."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for name, sub in kids:
        out += tree_leaves_with_path(sub, f"{path}/{name}" if path else name)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure; a ``None`` leaf stays ``None``."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, tree[k], *(r[k] for r in rest)))
                          for k in tree)
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """``like``'s structure with ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(sub):
        if isinstance(sub, dict):
            made = {k: build(sub[k]) for k in sorted(sub)}
            return type(sub)((k, made[k]) for k in sub)
        if _is_namedtuple(sub):
            return type(sub)(*(build(x) for x in sub))
        if isinstance(sub, (list, tuple)):
            return type(sub)(build(x) for x in sub)
        return next(it)

    return build(like)


def unstack(tree, n: int) -> list:
    """The ``n`` per-layer slices of a stacked tree (leading ``L`` axis;
    dicts, NamedTuples and tuples of them alike).

    One ``torch.unbind`` a leaf: its backward stacks the ``n`` gradients
    once, where a per-layer index would write a full-size zero tensor a
    layer."""
    per_leaf = [torch.unbind(t, 0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[i] for p in per_leaf]) for i in range(n)]


# --------------------------------------------------------------------------
# initialization and counts

def init_from_specs(specs: PyTree, key: torch.Generator,
                    device=None, finish: Callable = None) -> PyTree:
    """Initialize a parameter tree from its spec tree.

    The reference's leaf-name rules: '*norm*', '*scale' and '/g_' -> ones;
    '*bias*', '*_b' and 'decay0' -> zeros; everything else a truncated
    normal within +-3 sigma, sigma = min(0.02, fan_in ** -0.5).  The draws
    come from ``key`` (a ``torch.Generator``) leaf by leaf in JAX's
    flattening order on the generator's device, and the tree is put on
    ``device`` (default: the generator's device); the draws' bits are the
    port's own, not ``jax.random``'s.  ``finish(path, leaf)``, when given,
    maps each leaf as soon as it is drawn (a cast, say), so the float32
    draws never coexist.
    """
    device = torch.device(device) if device is not None else key.device

    def init_leaf(name, s):
        name = name.lower()
        if "norm" in name or name.endswith("scale") or "/g_" in name:
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if "bias" in name or name.endswith("_b") or "decay0" in name:
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = min(0.02, fan_in ** -0.5)
        t = torch.empty(s.shape, dtype=torch.float32, device=key.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=key)
        return t.mul_(std).to(device=device, dtype=s.dtype)

    leaves = []
    for path, s in tree_leaves_with_path(specs):
        leaf = init_leaf(path, s)
        leaves.append(finish(path, leaf) if finish else leaf)
    return tree_unflatten(specs, leaves)


def count_params(specs: PyTree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


# --------------------------------------------------------------------------
# numerics

def use_reference_numerics() -> None:
    """Keep cuBLAS's bf16 products to the reference's rounding: float32
    accumulation rounded once.  Its default lets split-K partial sums
    round to bf16 first.  A process-wide flag of PyTorch."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def cast(x: torch.Tensor, dtype=COMPUTE_DTYPE) -> torch.Tensor:
    return x.to(dtype)


@functools.lru_cache(maxsize=None)
def _out_dtype_mm(device_type: str) -> bool:
    """Whether this build's ``torch.mm`` / ``torch.bmm`` take ``out_dtype``
    on the device type (a bf16 product with a float32 result on the tensor
    cores); the CPU build registers them for Meta only."""
    if device_type != "cuda":
        return False
    a = torch.ones(2, 2, dtype=COMPUTE_DTYPE, device=device_type)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
        torch.bmm(a[None], a[None], out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return False
    return True


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not _out_dtype_mm(a.device.type) or (
            is_dtensor(a) and not register_out_dtype_products()):
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:                      # (..., K) @ (K, N): one product
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.bmm(a3, b3, out_dtype=torch.float32)
    return out.reshape(*batch, a.shape[-2], b.shape[-1])


class _MatmulF32(torch.autograd.Function):
    """:func:`matmul_f32` under autograd (``out_dtype`` products have no
    derivative in PyTorch): the gradients are the float32 products of the
    float32 cotangent with the other operand, rounded to the operands'
    bf16, as autograd through ``a.float() @ b.float()`` gives them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().mT).sum_to_size(a.shape)
            ga = ga.to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                gb = (a.reshape(-1, a.shape[-1]).float().mT
                      @ g.reshape(-1, g.shape[-1]))
            else:
                gb = torch.matmul(a.float().mT, g).sum_to_size(b.shape)
            gb = gb.to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands with a float32 result: the reference's
    ``dot_general(..., preferred_element_type=float32)``.

    Products of bf16 values are exact in float32, so the float32 product
    of the bf16-rounded operands gives the reference's value up to the
    accumulation order.  On a build whose CUDA ``mm`` / ``bmm`` take
    ``out_dtype``, the bf16 tensor cores accumulate in float32 instead.
    """
    a, b = cast(a), cast(b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32.apply(a, b)
    return _mm_f32(a, b)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b=None,
          bf16_wire: bool = False) -> torch.Tensor:
    """x @ w in bf16 with float32 accumulation; x: (..., d_in), w: (d_in,
    d_out).  Without a bias the product rounds to bf16 once; with one the
    bias is added in float32 before that rounding.  ``bf16_wire`` (the
    reference's bf16 partial-sum wire format) rounds the product before the
    bias add.  On a mesh each rank multiplies its own pieces
    (``constraints.parallel_product``; on plain tensors, the product)."""
    def product(x, w, b):
        if b is None:
            return torch.matmul(cast(x), cast(w))
        y = (torch.matmul(cast(x), cast(w)).float() if bf16_wire
             else matmul_f32(x, w))
        return (y + b.float()).to(COMPUTE_DTYPE)

    return parallel_product(product, x, w, b)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """(..., head_dim//2) rotation angles for given integer positions."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=positions.device)
                             / head_dim))
    return positions.float()[..., None] * freqs


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); angles: (B, S, hd//2) or (S, hd//2)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w1, w3, w2, bf16_wire: bool = False
           ) -> torch.Tensor:
    """LLaMA-style gated MLP: (silu(x@w1) * (x@w3)) @ w2."""
    return dense(F.silu(dense(x, w1).float()).to(COMPUTE_DTYPE)
                 * dense(x, w3), w2, bf16_wire=bf16_wire)


def _ce_local(logits: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse, ll


def ce_terms(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, label logit) of float32 logits (..., V), per token.

    On a mesh this is a local map: the vocab dimension is gathered whole
    (DTensor has no strategy for a gather along a sharded dimension), the
    labels take the logits' batch placements, and each rank computes its
    own tokens' terms (DTensor's ``gather`` backward would allocate the
    global-shape zeros on every rank).  On plain tensors, the terms."""
    if not is_dtensor(logits):
        return _ce_local(logits.float(), labels)
    from torch.distributed.tensor import DTensor
    logits = unshard(logits.float(), -1)
    place = logits.placements
    lse, ll = _ce_local(logits.to_local(),
                        redistribute(labels, place).to_local())
    shape = tuple(labels.shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return tuple(DTensor.from_local(t, logits.device_mesh, place,
                                    run_check=False, shape=shape,
                                    stride=stride) for t in (lse, ll))


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE; logits (..., V) in float32, labels (...) int."""
    lse, ll = ce_terms(logits, labels)
    return torch.mean(lse - ll)
