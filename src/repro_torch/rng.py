"""Threefry-2x32 counter-based random numbers, bit-exact with ``jax.random``.

The reference draws every random number of a run (initial labels, the
per-iteration tie-break noise and migration draws) from ``jax.random``'s
default threefry2x32 generator in its partitionable mode (the default of
jax 0.9).  Reproducing those bits is what lets a run here be compared
with a reference run label for label, so this module re-implements the
four calls the main path makes -- ``PRNGKey``, ``split``, ``uniform`` and
``randint`` -- with the same counters and the same bit manipulation.

A key is a pair of Python ints in [0, 2**32).  Random bits are computed
on int64 tensors holding uint32 values: every add is followed by a mask
to 32 bits, so the int64 arithmetic is the uint32 arithmetic of the
reference.  In partitionable mode the counter of element ``i`` of an
output is the flat index split as ``(i >> 32, i & 0xffffffff)`` and the
32-bit output is ``b0 ^ b1``; ``split`` stacks ``(b0, b1)``.  Because the
counter is the flat index, large outputs are generated in row blocks
(bounding the int64 temporaries) without changing a bit, and a slice of
an output (``uniform(..., offset=)``, a shard's rows of a replicated
draw) is drawn from its own counters alone.

``uniform_many`` draws the same output for many keys in one pass (the
batched runner's per-tenant draws): the key words broadcast as ``(nb,
1)`` columns against the ``(1, n)`` counters, so row ``b`` is bit for bit
``uniform(keys[b], ...)``.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements per block of generated bits: bounds the int64 temporaries
# (8 bytes each, a handful alive) to a few hundred MB
_BLOCK = 1 << 24

Word = Union[int, torch.Tensor]


def _rounds(x0: Word, x1: Word, rot) -> Tuple[Word, Word]:
    for r in rot:
        x0 = (x0 + x1) & _M32
        x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
    return x0, x1


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word
                 ) -> Tuple[Word, Word]:
    """The threefry2x32 block function (20 rounds) on uint32 words.

    Every word is a Python int or an int64 tensor of uint32 values; the
    tensors broadcast (key columns against counter rows draw for many
    keys at once).  Returns the two output words.
    """
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROT[i % 2])
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` under jax's default 32-bit mode: the
    seed is taken as a 32-bit integer, so the high word is 0."""
    return (0, int(seed) & _M32)


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` as a list of ``num`` keys."""
    k0, k1 = key
    return [threefry2x32(k0, k1, 0, i) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the block function of the key
    over the counter ``(0, data)``, ``data`` taken as a uint32."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def _bit_blocks(key: Key, n: int, device, offset: int = 0):
    """``(start, stop, bits)`` over the flat outputs ``[0, n)`` at counters
    ``offset + i``, ``_BLOCK`` at a time."""
    for start in range(0, n, _BLOCK):
        stop = min(n, start + _BLOCK)
        idx = torch.arange(offset + start, offset + stop, dtype=torch.int64,
                           device=device)
        b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
        yield start, stop, b0 ^ b1


def _key_words(keys, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(nb, 1)`` int64 columns of a list of keys' words, or of an
    ``(nb, 2)`` int64 tensor of them (used as it is: no host copy)."""
    if not isinstance(keys, torch.Tensor):
        keys = torch.tensor([[int(a), int(b)] for a, b in keys],
                            dtype=torch.int64, device=device)
    return keys[:, :1], keys[:, 1:]


def uniform_many(keys, shape, minval: float = 0.0, maxval: float = 1.0, *,
                 device) -> torch.Tensor:
    """``uniform(key, shape, minval, maxval)`` for every key of ``keys`` in
    one pass: an ``(nb, *shape)`` tensor whose row ``b`` is bit for bit
    ``uniform(keys[b], shape, minval, maxval)``.

    ``keys`` is a list of keys or an ``(nb, 2)`` int64 tensor of their
    uint32 words on ``device``.  Blocks of the flat counters bound the
    int64 temporaries to ``_BLOCK`` elements across the batch.
    """
    shape = tuple(int(s) for s in shape)
    k0, k1 = _key_words(keys, device)
    nb, n = k0.shape[0], math.prod(shape)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    out = torch.empty((nb, n), dtype=torch.float32, device=device)
    block = max(1, _BLOCK // max(nb, 1))
    for start in range(0, n, block):
        stop = min(n, start + block)
        idx = torch.arange(start, stop, dtype=torch.int64,
                           device=device)[None, :]
        b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & _M32)
        out[:, start:stop] = torch.clamp(_bits_to_unit(b0 ^ b1) * span + lo,
                                         min=lo)
    return out.reshape((nb,) + shape)


def random_bits(key: Key, shape, device) -> torch.Tensor:
    """32 random bits per element (int64 tensor of uint32 values)."""
    shape = tuple(int(s) for s in shape)
    out = torch.empty(math.prod(shape), dtype=torch.int64, device=device)
    for start, stop, bits in _bit_blocks(key, out.numel(), device):
        out[start:stop] = bits
    return out.reshape(shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa trick: 23 random bits under exponent 0, minus 1 -> [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0, *,
            device, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.

    With ``offset`` the result is the flat elements ``[offset, offset +
    prod(shape))`` of a larger draw from the same key: e.g. rows ``[r,
    r + n)`` of a ``(V, k)`` draw are ``uniform(key, (n, k), offset=r * k)``.

    Bit-exact for ``minval == 0``, which is every draw of the main path
    (tie noise in [0, tie), migration draws in [0, 1)).  For other
    ``minval`` XLA may contract the scale and shift into one fused
    multiply-add, which rounds once where this rounds twice.
    """
    shape = tuple(int(s) for s in shape)
    # float32 bounds as host scalars: PyTorch multiplies and adds a host
    # scalar in the tensor's float32, and creating device scalars here
    # would cost a host-device copy (and a stream sync) per draw
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    out = torch.empty(math.prod(shape), dtype=torch.float32, device=device)
    for start, stop, bits in _bit_blocks(key, out.numel(), device, offset):
        out[start:stop] = torch.clamp(_bits_to_unit(bits) * span + lo,
                                      min=lo)
    return out.reshape(shape)


def randint(key: Key, shape, minval: int, maxval: int, *,
            device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``.

    Two subkeys give a high and a low 32-bit word per element; the
    offset is ``(hi % span * (2**32 % span) + lo % span) % span`` in
    wrapping uint32 arithmetic, exactly the reference's formula.
    """
    k_hi, k_lo = split(key)
    hi_bits = random_bits(k_hi, shape, device)
    lo_bits = random_bits(k_lo, shape, device)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((((hi_bits % span) * mult) & _M32) + (lo_bits % span)) & _M32
    off = off % span
    return (off + minval).to(torch.int32)
