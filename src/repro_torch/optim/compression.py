"""Gradient compression with error feedback (the port of
``repro.optim.compression``).

int8 block-quantized all-reduce: gradients are quantized per 256-value
block to int8 with a float32 scale (~3.76x wire compression), and the
quantization residual is carried into the next step (error feedback,
Karimireddy et al. 2019).  ``compress`` / ``decompress`` are pure
functions to put around any collective.

Every division is tensor by tensor: PyTorch multiplies by the reciprocal
of a host scalar divisor, the reference divides.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.common import tree_map

PyTree = Any

BLOCK = 256


class Compressed(NamedTuple):
    q: torch.Tensor        # int8 (n_blocks, BLOCK)
    scale: torch.Tensor    # float32 (n_blocks,)
    n: int                 # original element count


def compress(x: torch.Tensor) -> Compressed:
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    flat = F.pad(flat, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1) / torch.full(
        (1,), 127.0, device=flat.device)
    q = torch.round(flat / torch.clamp_min(scale, 1e-12)[:, None])
    return Compressed(q.to(torch.int8), scale, n)


def decompress(c: Compressed, shape) -> torch.Tensor:
    flat = c.q.float() * c.scale[:, None]
    return flat.reshape(-1)[: c.n].reshape(shape)


def _is_compressed(x) -> bool:
    return isinstance(x, Compressed)


def _map_compressed(fn, comp, *rest):
    """``fn`` over the ``Compressed`` records of ``comp`` (which the
    generic tree map would open as NamedTuples)."""
    if _is_compressed(comp):
        return fn(comp, *rest)
    if isinstance(comp, dict):
        return type(comp)((k, _map_compressed(fn, comp[k],
                                              *(r[k] for r in rest)))
                          for k in comp)
    return type(comp)(_map_compressed(fn, *xs) for xs in zip(comp, *rest))


def compress_tree(grads: PyTree, errors: Optional[PyTree] = None):
    """Quantize a gradient tree, carrying error feedback.

    Returns (compressed_tree, new_errors): the caller all-reduces the int8
    payloads, then applies ``decompress_tree``.  new_errors = grad -
    dequant(quant(grad + error)) must be fed into the next call.
    """
    if errors is None:
        errors = tree_map(torch.zeros_like, grads)
    corrected = tree_map(lambda g, e: g.float() + e, grads, errors)
    comp = tree_map(compress, corrected)
    restored = _map_compressed(lambda c, g: decompress(c, g.shape), comp,
                               grads)
    new_errors = tree_map(lambda c, r: c - r, corrected, restored)
    return comp, new_errors


def decompress_tree(comp, like: PyTree) -> PyTree:
    return _map_compressed(
        lambda c, g: decompress(c, g.shape).to(g.dtype), comp, like)


def wire_bytes(comp) -> int:
    total = 0
    stack = [comp]
    while stack:
        c = stack.pop()
        if _is_compressed(c):
            total += c.q.numel() + 4 * c.scale.numel()
        elif isinstance(c, dict):
            stack.extend(c.values())
        else:
            stack.extend(c)
    return total
