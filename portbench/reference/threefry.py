"""Threefry-2x32 random streams, the benchmark's own frozen copy.

Spinner draws its initial labels, its tie-break noise and its migration
draws from JAX's default generator (threefry2x32 in its partitionable
mode).  The plain reference below re-draws those streams itself, so it
imports nothing of the program under test.  The arithmetic follows the
Random123 definition of threefry2x32 with 20 rounds and JAX's counter
layout:

* a key is a pair of 32-bit words; ``seed_key(s)`` is ``(0, s mod 2**32)``;
* ``split(key)`` gives the block function of the key at counters
  ``(0, 0)`` and ``(0, 1)``;
* ``uniform(key, n)`` draws element ``i`` from the counter
  ``(i >> 32, i & 0xffffffff)``, takes ``b0 ^ b1``, keeps its top 23 bits
  as the mantissa of a float in [1, 2) and subtracts 1, then scales.

Words are held in int64 tensors (or Python ints) and masked to 32 bits
after every add, so the int64 arithmetic is the uint32 arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
BLOCK = 1 << 24          # elements of generated bits per pass


def block(k0, k1, x0, x1):
    """The threefry2x32 block function on 32-bit words (ints or int64
    tensors); returns the two output words."""
    keys = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for group in range(5):
        for r in ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + keys[(group + 1) % 3]) & MASK
        x1 = (x1 + keys[(group + 2) % 3] + group + 1) & MASK
    return x0, x1


def seed_key(seed: int) -> tuple:
    return (0, int(seed) & MASK)


def split(key: tuple) -> tuple:
    """Two keys from one: the block function at counters (0, 0), (0, 1)."""
    return tuple(block(key[0], key[1], 0, i) for i in range(2))


def uniform(key: tuple, n: int, maxval: float, device) -> torch.Tensor:
    """``n`` float32 draws in [0, maxval) from ``key``'s stream."""
    span = float(np.float32(maxval))
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, BLOCK):
        stop = min(n, start + BLOCK)
        i = torch.arange(start, stop, dtype=torch.int64, device=device)
        b0, b1 = block(key[0], key[1], i >> 32, i & MASK)
        bits = b0 ^ b1
        unit = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0
        out[start:stop] = torch.clamp(unit * span + 0.0, min=0.0)
    return out
